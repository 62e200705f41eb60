"""The port's surface against the reference's, name by name.

Every module of ``src/repro`` is read by AST (nothing of it is imported,
so the test needs no JAX).  Each public top-level name it defines (and
each name a package ``__init__.py`` imports) must either exist at the top
level of the port's module of the same path, or stand in ``TABLE`` as a
rename or an omission with its reason and the port's module that records
the decision; that module's text must name it.  An entry goes stale, and
fails, when the reference no longer has the name or the port has gained
it.  The reference packages' ``__all__`` lists must be covered by the
port's, and every name of the five ported package surfaces must import
in a process where neither ``jax`` nor ``repro`` can be imported.

A new rename or omission is recorded here, in ``TABLE``.
"""
import ast
import subprocess
import sys
import textwrap
from pathlib import Path
from typing import NamedTuple, Optional

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

# reference module -> the port's module that holds its names
MODULE_MAP = {f"kernels/{m}.py": "kernels/norm_attention.py"
              for m in ("flash_attention", "decode_attention", "rmsnorm")}


class Entry(NamedTuple):
    reason: str
    record: str                   # the port's module that records it
    to: Optional[str] = None      # a rename: "name" or "port/module.py::name"


_PALLAS = "a Pallas kernel is a CUDA kernel here (*_pallas -> *_cuda)"
_PLAIN = "a plain version is *_plain here (*_ref -> *_plain)"
_KINIT = "kernels/__init__.py"
_ARRAY = "the jax.Array type alias; the port annotates with torch.Tensor"
_NOMESH = "lays a model out over a TPU device mesh; one card has none"
_DICTS = "parameters and caches are dicts with the same keys"

# (reference module, name) -> entry; a name of None omits the whole module
TABLE: dict[tuple[str, Optional[str]], Entry] = {
    **{(f"kernels/{m}.py", f"{n}_pallas"): Entry(_PALLAS, _KINIT,
                                                 to=f"{n}_cuda")
       for m, n in (("grouped_matmul", "grouped_matmul"),
                    ("grouped_matmul", "grouped_swiglu"),
                    ("grouped_matmul", "grouped_swiglu_db"),
                    ("grouped_matmul", "gather_swiglu_scatter"),
                    ("quantize_pack", "gather_quantize"),
                    ("quantize_pack", "dequantize"),
                    ("decode_attention", "decode_attention"),
                    ("flash_attention", "flash_attention"),
                    ("rmsnorm", "rmsnorm"),
                    ("mamba_scan", "mamba_scan"),
                    ("combine_reduce", "combine_reduce"))},
    **{(f"kernels/{m}.py", f"{n}_ref"): Entry(_PLAIN, _KINIT, to=f"{n}_plain")
       for m, n in (("quantize_pack", "gather_quantize"),
                    ("quantize_pack", "dequantize"),
                    ("decode_attention", "decode_attention_paged"))},
    ("kernels/decode_attention.py", "decode_attention_paged"):
        Entry("the paged Pallas kernel is a CUDA kernel here", _KINIT,
              to="decode_attention_paged_cuda"),
    ("kernels/ref.py", "mamba_scan_ref"):
        Entry("the plain scan sits beside its kernel", _KINIT,
              to="kernels/mamba_scan.py::mamba_scan_plain"),
    ("kernels/ops.py", "KERNEL_MODE"):
        Entry("the TPU's Pallas / interpret / ref switch; a wrapper picks "
              "its kernel by the tensor's device", _KINIT),
    ("kernels/ops.py", "GSS_VMEM_BYTES"):
        Entry("the TPU's VMEM gate of the fused HT kernel; the CUDA kernel "
              "streams its weights", _KINIT),
    ("core/backend.py", "JaxCollectivesBackend"):
        Entry("the collectives backend runs torch, not jax",
              "core/backend.py", to="TorchCollectivesBackend"),
    ("core/ep.py", "NEG"):
        Entry("a jnp int32 -1; the port writes the literal", "core/ep.py"),
    **{("models/layers.py", n): Entry(_DICTS, "models/layers.py")
       for n in ("AttnParams", "MLPParams", "KVCache")},
    ("models/blocks.py", "BlockCache"):
        Entry("a layer's cache is a dict of its own kind's tensors",
              "models/blocks.py"),
    ("models/layers.py", "decode_attention_local"):
        Entry("the decode island of a sequence-sharded cache; one card "
              "holds the whole cache", "models/layers.py"),
    ("compat.py", None):
        Entry("shims over jax versions; the port imports no jax",
              "launch/__init__.py"),
    ("launch/dryrun.py", None):
        Entry("records XLA's compiled cost of a TPU mesh",
              "launch/__init__.py"),
    ("launch/specs.py", None):
        Entry("sharded abstract values for the dry run", "launch/__init__.py"),
    ("launch/regen_roofline.py", None):
        Entry("re-reads the dry run's records", "launch/__init__.py"),
    ("launch/roofline.py", "collective_bytes_from_hlo"):
        Entry("parses partitioned HLO, which torch does not produce",
              "launch/roofline.py"),
    ("launch/mesh.py", "ICI_BW"):
        Entry("the TPU's inter-chip bandwidth", "launch/mesh.py"),
    **{("launch/mesh.py", n): Entry("builds a device mesh; one card has none",
                                    "launch/mesh.py")
       for n in ("make_bench_mesh", "make_production_mesh")},
    **{("launch/train.py", n): Entry("XLA's latency-hiding flags",
                                     "launch/train.py")
       for n in ("XLA_PIPELINING_FLAGS", "apply_xla_pipelining_flags")},
    ("training/train_loop.py", "state_shardings"):
        Entry(_NOMESH, "training/train_loop.py"),
    **{("distributed/sharding.py", n): Entry(_NOMESH, "distributed/sharding.py")
       for n in ("act_spec", "batch_spec", "cache_pspecs", "cache_seq_axes",
                 "effective_batch_axes", "param_pspecs", "param_shardings")},
    **{(m, "Array"): Entry(_ARRAY, "__init__.py")
       for m in ("core/ep.py", "core/moe.py", "core/plan.py",
                 "core/routing.py", "core/transport/codec.py",
                 "distributed/compression.py", "kernels/ref.py",
                 "models/blocks.py", "models/layers.py", "models/mamba.py",
                 "models/model_zoo.py", "optim/adamw.py",
                 "training/train_loop.py")},
}

# the packages whose surface the port closes (all five export names now)
PACKAGES = ("core", "optim", "training", "data", "distributed")


def _module_body(tree: ast.Module):
    """Top-level statements, with those under a top-level if / try / with
    (a name bound there is still a module name)."""
    todo = list(tree.body)
    while todo:
        n = todo.pop(0)
        yield n
        if isinstance(n, ast.If):
            todo += n.body + n.orelse
        elif isinstance(n, ast.Try):
            todo += n.body + n.orelse + n.finalbody
            for h in n.handlers:
                todo += h.body
        elif isinstance(n, ast.With):
            todo += n.body


def _all_list(tree: ast.Module) -> Optional[list]:
    for n in tree.body:
        if (isinstance(n, ast.Assign) and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Name)
                and n.targets[0].id == "__all__"):
            return [e.value for e in n.value.elts]
    return None


def _bound(path: Path, imports: bool) -> set:
    """Names a module binds at its top level: defs, classes, assignments,
    and (with ``imports``) the names it imports from a module.  A module
    with a ``__getattr__`` also serves the names of its ``__all__``."""
    tree = ast.parse(path.read_text())
    out = set()
    for n in _module_body(tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            for t in targets:
                out |= {e.id for e in ast.walk(t) if isinstance(e, ast.Name)}
        elif imports and isinstance(n, ast.ImportFrom):
            out |= {a.asname or a.name for a in n.names}
    if "__getattr__" in out:
        out |= set(_all_list(tree) or ())
    return out


def _ref_names(rel: str) -> set:
    """The reference module's public names: what it defines, and for a
    package ``__init__.py`` what it imports too (its exports)."""
    path = REF / rel
    names = _bound(path, imports=path.name == "__init__.py")
    return {n for n in names if not n.startswith("_")}


def _port_path(rel: str) -> Path:
    return PORT / MODULE_MAP.get(rel, rel)


REF_MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def test_every_reference_module_is_walked():
    assert len(REF_MODULES) > 60
    assert {"core/plan.py", "core/__init__.py", "launch/dryrun.py",
            "kernels/rmsnorm.py"} <= set(REF_MODULES)


@pytest.mark.parametrize("rel", REF_MODULES)
def test_every_public_name_has_a_counterpart(rel):
    if (rel, None) in TABLE:
        assert not _port_path(rel).exists(), f"{rel} is ported now"
        return
    port = _port_path(rel)
    assert port.exists(), f"no port of {rel} and no table entry"
    have = _bound(port, imports=True)
    missing = sorted(n for n in _ref_names(rel)
                     if n not in have and (rel, n) not in TABLE)
    assert not missing, (f"{rel}: no counterpart in {port.relative_to(ROOT)}"
                         f" and no entry in TABLE: {missing}")


@pytest.mark.parametrize("key", sorted(TABLE, key=str),
                         ids=lambda k: f"{k[0]}::{k[1]}")
def test_table_entry_is_not_stale(key):
    rel, name = key
    entry = TABLE[key]
    assert entry.reason
    record = PORT / entry.record
    assert record.exists(), entry.record
    text = record.read_text()
    if name is None:
        assert (REF / rel).exists(), f"the reference no longer has {rel}"
        assert not _port_path(rel).exists(), f"{rel} is ported now"
        assert Path(rel).name in text, f"{entry.record} does not name {rel}"
        return
    assert name in _ref_names(rel), f"the reference's {rel} lost {name}"
    port = _port_path(rel)
    if port.exists():
        assert name not in _bound(port, imports=True), (
            f"{name} exists in the port's {rel} now: drop its entry")
    if entry.to is not None:
        mod, _, to = entry.to.rpartition("::")
        target = PORT / mod if mod else port
        assert to in _bound(target, imports=True), (
            f"rename target {entry.to} is missing")
    # the record names the reference's name (a *_pallas or *_ref rename
    # may be named by its pattern)
    assert name in text or any(
        entry.to and name.endswith(sfx) and f"*{sfx}" in text
        for sfx in ("_pallas", "_ref")), (
        f"{entry.record} does not record {rel}::{name}")


REF_ALLS = sorted(str(p.relative_to(REF)) for p in REF.rglob("__init__.py")
                  if _all_list(ast.parse(p.read_text())) is not None)


@pytest.mark.parametrize("rel", REF_ALLS)
def test_package_all_covers_the_reference(rel):
    ref_all = _all_list(ast.parse((REF / rel).read_text()))
    port_all = _all_list(ast.parse((PORT / rel).read_text()))
    assert port_all is not None, f"the port's {rel} has no __all__"
    missing = sorted(set(ref_all) - set(port_all))
    assert not missing, f"{rel}: {missing}"


@pytest.mark.parametrize("pkg", PACKAGES)
def test_package_exports_what_the_reference_exports(pkg):
    """Each closed package's ``__all__`` is the reference's: its ``__all__``
    where it has one, else the names its ``__init__.py`` imports."""
    rel = f"{pkg}/__init__.py"
    ref_tree = ast.parse((REF / rel).read_text())
    ref_names = _all_list(ref_tree)
    if ref_names is None:
        ref_names = sorted(_ref_names(rel))
    port_all = _all_list(ast.parse((PORT / rel).read_text()))
    assert sorted(port_all) == sorted(ref_names)


def test_package_names_import_without_jax_or_the_reference():
    """Every name of the five ``__all__`` lists imports from its package
    of ``repro_torch`` while ``jax`` and ``repro`` cannot be imported."""
    code = textwrap.dedent("""
        import importlib, sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                top = name.partition(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    raise ImportError(f"{name} is blocked")
                return None
        sys.meta_path.insert(0, Block())
        sys.path.insert(0, %r)
        for pkg in %r:
            mod = importlib.import_module("repro_torch." + pkg)
            for n in mod.__all__:
                getattr(mod, n)
            print(pkg, len(mod.__all__))
        bad = sorted(m for m in sys.modules
                     if m.partition(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
    """) % (str(ROOT / "src"), PACKAGES)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    got = dict(line.split() for line in r.stdout.split("\n") if line)
    assert set(got) == set(PACKAGES)
