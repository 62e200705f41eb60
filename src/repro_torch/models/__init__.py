# ``models.layers`` imports the kernels, which import ``repro_torch.core``,
# whose MoE layer imports ``models.layers`` back.  Loading ``core`` first,
# before any model module starts, keeps that cycle from meeting a
# half-loaded ``models.layers`` (as ``kernels/__init__.py`` does).
import repro_torch.core  # noqa: F401
