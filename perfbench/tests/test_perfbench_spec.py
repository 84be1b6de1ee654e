"""The benchmark finds every cell, configuration, traffic mix and metric
reader by name, and BENCHMARK.json keeps the contract's shape."""
import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import spec  # noqa: E402

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found(w):
    cell = spec.cell(w["name"])
    assert cell["config"] == w["config"]
    assert cell["traffic"] == w["traffic"]
    spec.traffic(w["traffic"])
    assert w["chips"] == 1
    assert len(w["why"]) <= 200


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_found(c):
    conf = spec.config(c["name"])
    assert (ROOT / c["file"]).exists()
    assert conf["source"] == c["source"]
    assert conf["reduced"] == c["reduced"]
    assert conf["model"]["name"] == c["name"]
    for key in c["reduced"]:
        assert key in conf["published"] and conf[key] != conf["published"][key]
    # every number of the file outside ``reduced`` is the published one
    # the model dict serves
    served = {"hidden_size": "d_model", "intermediate_size": "d_ff",
              "num_attention_heads": "num_heads",
              "num_key_value_heads": "num_kv_heads", "head_dim": "head_dim",
              "num_hidden_layers": "num_layers", "vocab_size": "vocab_size",
              "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
              "num_local_experts": "num_experts",
              "num_experts_per_tok": "experts_per_token"}
    for key, name in served.items():
        if key in conf:
            assert conf["model"][name] == conf[key], key
    assert (ROOT / "perfbench" / "reference" /
            f"{conf['reference']}.py").exists()


@pytest.mark.parametrize("mt", BENCH["per_layer"] + BENCH["end_to_end"],
                         ids=lambda m: m["name"])
def test_metric_readers_found(mt):
    assert NAME.match(mt["name"])
    if mt["name"] != "setup_s":
        assert callable(spec.reader(mt["name"]))
    for w in mt.get("workloads", []):
        spec.workload(BENCH, w)


def test_every_cell_reports_setup_an_end_to_end_and_a_layer_metric():
    names = {m["name"] for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in spec.metrics_for(BENCH, "end_to_end",
                                                   w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = spec.metrics_for(BENCH, "per_layer", w["name"])
        assert layer
        for m in layer:
            assert m["moves"] in names
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_layer_names_are_one_per_layer():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"engine loop", "scheduler / pool", "executor",
                      "chunk store / tiers", "model", "kernels", "device"}
