"""The benchmark's files: every configuration, traffic mix, metric reader
and limits file loads; names and units keep to the contract's
characters; each metric's ``workloads`` are cells that report its
end-to-end metric; a new cell is found by its names alone; the seeded
generators repeat."""
from __future__ import annotations

import json
import re
import shutil

import pytest
import torch

from epbench import common, weights
from epbench import run as R

BENCH = common.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["epbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
            for k in e.get("reduced", []):
                assert NAME.match(k)
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert len(w["why"]) <= 200 and w["chips"] == 1


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    c, conf, traffic, limits = R.prepare(cell, BENCH)
    assert conf["name"] == c["config"]
    cfg = common.model_config(conf, traffic)
    assert cfg.n_layers == traffic.get("layers", conf["num_hidden_layers"])
    assert (common.HERE / "traffic" / f"{traffic['driver']}.py").exists()
    assert set(limits) and all("limit" in v for v in limits.values())


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_agrees_with_port(name):
    """The file's published keys, its ``port`` block and the port's own
    registered configuration agree on every width."""
    from repro_torch.configs import get_config
    conf = common.config_file(name)
    port = conf["port"]
    reg = get_config(name)
    assert port["d_model"] == conf["hidden_size"] == reg.d_model
    assert port["n_heads"] == conf["num_attention_heads"] == reg.n_heads
    assert port["n_kv_heads"] == conf["num_key_value_heads"] == \
        reg.n_kv_heads
    assert port["head_dim"] == reg.head_dim_
    assert port["vocab_size"] == conf["vocab_size"] == reg.vocab_size
    assert port["moe"]["d_expert"] == conf["moe_intermediate_size"] == \
        reg.moe.d_expert
    assert port["moe"]["top_k"] == conf["num_experts_per_tok"] == \
        reg.moe.top_k
    assert port["moe"]["n_experts"] == reg.moe.n_experts
    assert port["moe"]["d_shared"] == reg.moe.d_shared
    assert port["n_layers"] == conf["num_hidden_layers"] == reg.n_layers
    assert port["rope_theta"] == reg.rope_theta
    assert port["qkv_bias"] == reg.qkv_bias
    assert port["norm_eps"] == reg.norm_eps
    # where the port runs otherwise than published, the file says so apart
    if port["norm_eps"] != conf["rms_norm_eps"]:
        assert "rms_norm_eps" in conf["departures"]
    if port["moe"]["aux_loss_weight"] != conf["router_aux_loss_coef"]:
        assert "router_aux_loss_coef" in conf["departures"]
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    assert entry["file"] == f"epbench/configs/{name}.json"
    assert entry["source"] == conf["source"]
    # `reduced` names the cut of scale alone
    assert set(entry["reduced"]) == set(conf["cut"]) - {"cells", "why"}


def test_metric_readers_and_workloads():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        mod = common.load_module("metrics", m["name"])
        assert callable(mod.read) and mod.read({}) is None
        assert m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", CELLS)
        assert set(m["workloads"]) <= set(moved), m["name"]
    for cell in CELLS:
        got = common.metrics_of_cell(BENCH, cell, "end_to_end")
        assert "setup_s" in [m["name"] for m in got] and len(got) >= 2
        assert common.metrics_of_cell(BENCH, cell, "per_layer")
        layers = {m["layer"] for m in BENCH["per_layer"]}
        assert all("\n" not in x for x in layers)


def test_new_cell_found_by_name(tmp_path):
    """A cell, a traffic mix and its limits added as files and entries,
    with no code edited, are found by the harness."""
    root = tmp_path / "epbench"
    shutil.copytree(common.HERE, root, ignore=shutil.ignore_patterns(
        "__pycache__"))
    mix = dict(common.traffic_file("ll_decode_b128_p64_g448"), batch=32)
    (root / "traffic" / "ll_decode_b32.json").write_text(json.dumps(mix))
    (root / "limits" / "qwen2moe-decode-b32.json").write_text(
        json.dumps({"mean_gap": {"limit": 1.0}}))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "qwen2moe-decode-b32",
                               "config": "qwen2_moe_a2_7b",
                               "traffic": "ll_decode_b32", "chips": 1,
                               "why": "a smaller decode batch"})
    cell, conf, traffic, limits = R.prepare("qwen2moe-decode-b32", bench,
                                            root)
    assert traffic["batch"] == 32 and conf["name"] == "qwen2_moe_a2_7b"
    assert common.load_module("traffic", traffic["driver"], root).run
    assert limits["mean_gap"]["limit"] == 1.0


def test_generators_repeat():
    from epbench.traffic import decode, train
    big = 2 ** 31 + 12345
    a = decode.prompts(big, 3, 4, 8, 1000, "cpu")
    assert torch.equal(a, decode.prompts(big, 3, 4, 8, 1000, "cpu"))
    assert not torch.equal(a, decode.prompts(big, 4, 4, 8, 1000, "cpu"))
    b = train.batch(big, 1, 2, 8, 1000, "cpu")
    assert torch.equal(b["tokens"], train.batch(big, 1, 2, 8, 1000,
                                                "cpu")["tokens"])
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_weights_repeat_and_match_initial_leaves():
    from test_epbench_reference import setup
    cfg, _ = setup({"ep_world": 4})
    a = weights.make_params(cfg, 2 ** 33 + 1, "cpu", torch.float32)
    b = weights.make_params(cfg, 2 ** 33 + 1, "cpu", torch.float32)
    la, lb = weights.leaves(a), weights.leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))
    again = dict(weights.initial_leaves(cfg, 2 ** 33 + 1, "cpu"))
    assert set(again) == {p for p, _ in la}
    assert all(torch.equal(again[p], t.detach()) for p, t in la)
    served = weights.make_params(cfg, 2 ** 33 + 1, "cpu", torch.bfloat16)
    assert served["blocks"][1]["moe"]["w_gate"].dtype == torch.bfloat16
    assert served["blocks"][1]["moe"]["router_w"].dtype == torch.float32
    assert served["blocks"][0]["ln1"].dtype == torch.float32


def test_padding_rules_match_the_port():
    from repro_torch.configs import get_config
    from repro_torch.core.moe import padded_experts_static
    for name in ("qwen2_moe_a2_7b", "moonshot_v1_16b_a3b"):
        cfg = get_config(name)
        assert weights.padded_experts(cfg.moe.n_experts) == \
            padded_experts_static(cfg)
        assert weights.padded_vocab(cfg.vocab_size) == cfg.padded_vocab()


def test_quantile_nearest_rank():
    v = list(range(1, 101))
    assert common.quantile(v, 0.95) == 95
    assert common.quantile([3.0], 0.95) == 3.0
