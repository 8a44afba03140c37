"""The harness on the CPU, at tiny sizes, in a copy of the benchmark to
which two cells, their configurations, traffic mixes and a metric were
added as new files and entries only: it finds them by name, drives the
program, and returns the result line's fields. With the timed path broken
underneath, ``correct`` comes out false. Without a card, or without the
program beside it, ``run.py`` exits non-zero and prints no result. And no
run loads JAX or the JAX package."""

import json
import subprocess
import sys

import pytest
import torch

from perfbench import bench
from perfbench.tests.tiny import ROOT, add_cells

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return add_cells(tmp_path_factory.mktemp("bench"))


@pytest.fixture(autouse=True)
def one_thread():
    """The tiny model on one thread: a window counts wall-clock seconds,
    and threads of its own fighting a loaded machine's leave it few
    steps."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _run(copy, cell, trace=False, seconds=1.0):
    return bench.run(cell, 2**31 + 9, seconds, trace, device="cpu",
                     root=copy)


@pytest.mark.parametrize("cell,e2e", [("t_open", ["ttft_p95_ms",
                                                  "itl_p95_ms"]),
                                      ("t_closed", ["output_tok_s"])])
def test_added_cell_runs_and_is_correct(copy, cell, e2e):
    res = _run(copy, cell)
    assert list(res)[:5] == KEYS and list(res)[-1] == "compared"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert set(res["metrics"]) == set(e2e) | {"setup_s", "dummy_steps"}
    assert res["metrics"]["dummy_steps"]["value"] > 0
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert res["device"]["platform"] == "cpu"
    names = set(res["compared"])
    assert names == {"mean_logit_gap", "unfinished_requests"}
    assert res["info"]["check"]["requests"]
    json.dumps(res)


def test_traced_run_reads_the_span_metrics(copy):
    res = _run(copy, "t_open", trace=True)
    # spans and counters are read; the device's metrics need the card
    assert {"queue_depth_mean", "itl_tail_ms", "prefill_ms",
            "decode_step_ms", "prefill_mfu_pct",
            "decode_mfu_pct"} <= set(res["metrics"])
    assert "moe_gmm_roofline_pct" not in res["metrics"]
    assert "breakdown" not in res


def _no_cache_write(monkeypatch):
    """A decode step that leaves its state unchanged: the new token's
    K/V (or latent) is never written into the cache."""
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "_cache_write",
                        lambda cache_arr, new, slot: None)


def _half_batch(monkeypatch):
    """Half the decode batch left out: the logits of the upper half of the
    occupied rows never computed."""
    from repro_torch.serving import ContinuousEngine
    orig = ContinuousEngine._decode_all

    def decode_all(self):
        logits = orig(self).clone()
        live = [i for i, r in enumerate(self.slots) if r is not None]
        logits[live[len(live) // 2:]] = 0.0
        return logits
    monkeypatch.setattr(ContinuousEngine, "_decode_all", decode_all)


def _altered_token(monkeypatch):
    """A token altered where it is produced: each decode's tokens are
    shifted by one id before they are emitted."""
    from repro_torch.serving import ContinuousEngine
    orig = ContinuousEngine._postdecode

    def postdecode(self, logits):
        return orig(self, torch.roll(logits, 1, dims=-1))
    monkeypatch.setattr(ContinuousEngine, "_postdecode", postdecode)


@pytest.mark.parametrize("fault", [_no_cache_write, _half_batch,
                                   _altered_token])
def test_broken_timed_path_is_not_correct(copy, monkeypatch, fault):
    fault(monkeypatch)
    # a window of several seconds, so that a loaded machine still serves
    # requests through many decode steps
    res = _run(copy, "t_closed", seconds=3.0)
    assert res["correct"] is False
    assert res["info"]["check"]["requests"]


def test_control_in_the_programs_place_is_not_correct(copy):
    """The float8 control's first choices, judged by the harness's own
    comparison of a window's requests, fail where the program's pass."""
    from perfbench import check
    seed = 2**31 + 11
    cell = bench.load_cell("t_closed", copy)
    h = bench.Harness(cell, cell.mix, seed, "cpu", trace=False)
    _, records, _, t_end = h.window(seed, 2.0)
    finished, failed = h.finished(records, t_end)
    positions = {}
    sides = h.compare(finished, failed, seed, ("fp8",), positions)
    assert check.passed(sides["program"][0])
    assert not check.passed(sides["fp8"][0])
    assert sides["fp8"][1]["requests"] == sides["program"][1]["requests"]
    assert positions["program"].shape == positions["fp8"].shape


def _script(code, cwd):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_run_refuses_without_a_card_or_without_the_program(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is of a machine without a card")
    res = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "phi35moe_longprompt", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and res.stdout == ""
    # a directory holding only BENCHMARK.json and the benchmark's files
    bare = tmp_path / "bare"
    add_cells(bare)
    res = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "t_open", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=bare, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0 and res.stdout == ""


def test_nothing_loads_jax_or_the_jax_package():
    """Top-level module names compared whole: ``repro_torch`` begins with
    ``repro`` and is allowed in the harness; the references load neither
    package."""
    code = """
import sys
sys.path[:0] = [{root!r}, {src!r}]
import perfbench.reference.decoder, perfbench.check
ref = sorted({{m.split(".")[0] for m in sys.modules}})
import perfbench.bench, perfbench.calibrate, perfbench.sweep
import perfbench.readers
from perfbench import bench
bench.setup_env(bench.ROOT)
bench.Harness  # the program is imported inside its set-up
import repro_torch.serving, repro_torch.models
harness = sorted({{m.split(".")[0] for m in sys.modules}})
print(ref)
print(harness)
""".format(root=str(ROOT), src=str(ROOT / "src"))
    res = _script(code, ROOT)
    assert res.returncode == 0, res.stderr
    ref, harness = (eval(line) for line in res.stdout.splitlines()[-2:])
    assert not {"jax", "jaxlib", "flax", "repro", "repro_torch"} & set(ref)
    assert not {"jax", "jaxlib", "flax", "repro"} & set(harness)
    assert "repro_torch" in harness
