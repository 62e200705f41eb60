"""The roofline on the card's constants (``repro_torch.launch.roofline``,
``repro_torch.launch.mesh``) against the reference's
``repro.launch.roofline`` on the CPU: ``model_flops`` and
``decode_ideal_bytes`` for all ten configs over the cells each runs,
``roofline_terms`` on synthetic records with the reference's TPU v5e
constants put in the port's module (then the same figures), and the H100
constants themselves."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import ARCH_IDS, SHAPES as J_SHAPES  # noqa: E402
from repro.configs import cells_for as j_cells_for  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import mesh as j_mesh  # noqa: E402
from repro.launch import roofline as J  # noqa: E402
from repro_torch.configs import SHAPES, cells_for, get_config  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.launch import roofline as R  # noqa: E402

CELLS = [(arch, cell) for arch in ARCH_IDS
         for cell in cells_for(get_config(arch))]


def test_the_same_cells():
    for arch in ARCH_IDS:
        assert cells_for(get_config(arch)) == j_cells_for(jget_config(arch))
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in J_SHAPES.items()}


@pytest.mark.parametrize("arch,cell", CELLS)
def test_model_flops_and_decode_bytes_equal_the_reference(arch, cell):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert R.model_flops(cfg, SHAPES[cell]) == J.model_flops(
        jcfg, J_SHAPES[cell])
    assert R.decode_ideal_bytes(cfg, SHAPES[cell]) == J.decode_ideal_bytes(
        jcfg, J_SHAPES[cell])


def _records():
    """Synthetic records: per-device flops, bytes and collective bytes
    that make each term dominate in turn, with and without the
    kernel-adjusted bytes, on 1 and 256 chips."""
    out = []
    for chips in (1, 256):
        for flops, nbytes, coll in ((5e15, 1e12, 1e10), (1e12, 5e13, 1e10),
                                    (1e12, 1e12, 5e12), (0.0, 0.0, 0.0)):
            rec = {"chips": chips,
                   "cost": {"flops": flops, "bytes_accessed": nbytes},
                   "collectives": {"total_bytes": coll}}
            out.append(rec)
            out.append({**rec, "cost": {**rec["cost"],
                                        "bytes_accessed_kernel_adj":
                                            nbytes / 7}})
    return out


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "qwen3_4b",
                                  "falcon_mamba_7b", "jamba_1_5_large_398b"])
def test_roofline_terms_equal_the_reference_on_its_constants(monkeypatch,
                                                             arch):
    """With the reference's v5e figures in the port's module the terms,
    the dominant term and the fractions equal the reference's; the
    collective term reads the link rate where the reference reads ICI."""
    monkeypatch.setattr(R, "PEAK_FLOPS_BF16", j_mesh.PEAK_FLOPS_BF16)
    monkeypatch.setattr(R, "HBM_BW", j_mesh.HBM_BW)
    monkeypatch.setattr(R, "NVLINK_BW", j_mesh.ICI_BW)
    cfg, jcfg = get_config(arch), jget_config(arch)
    for cell in cells_for(cfg):
        for rec in _records():
            assert R.roofline_terms(cfg, SHAPES[cell], rec) == \
                J.roofline_terms(jcfg, J_SHAPES[cell], rec), (cell, rec)


def test_roofline_terms_on_the_card():
    """On the H100 figures: a record of 989 TFLOP on one chip is one
    second of compute, 3.35 TB one second of memory, 450 GB one second of
    collective transfer."""
    cfg, cell = get_config("qwen2_moe_a2_7b"), SHAPES["train_4k"]
    rec = {"chips": 1, "cost": {"flops": 989e12, "bytes_accessed": 3.35e12},
           "collectives": {"total_bytes": 225e9}}
    out = R.roofline_terms(cfg, cell, rec)
    assert out["t_compute_s"] == pytest.approx(1.0)
    assert out["t_memory_s"] == pytest.approx(1.0)
    assert out["t_collective_s"] == pytest.approx(0.5)
    assert out["t_ideal_s"] == pytest.approx(
        R.model_flops(cfg, cell) / 989e12)
    assert "t_memory_kernel_s" not in out


def test_the_h100_constants():
    assert t_mesh.PEAK_FLOPS_BF16 == 989e12
    assert t_mesh.HBM_BW == 3.35e12
    assert t_mesh.NVLINK_BW == 450e9
    assert not hasattr(t_mesh, "ICI_BW")
    assert not hasattr(t_mesh, "make_production_mesh")
    assert R.PEAK_FLOPS_BF16 is t_mesh.PEAK_FLOPS_BF16
