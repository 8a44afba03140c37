"""Both references against the program on the CPU: the program's one-shot
prefill into a slot and its decode through the cache, against one causal
forward pass of the reference over the whole sequence, logits compared at
every served position; then the control, which must read farther off
than the program does."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench import check
from perfbench.reference.decoder import Decoder
from perfbench.tests.tiny import GQA, MLA
from perfbench.weights import Weights


def _program_and_reference(conf, dtype):
    from repro_torch.models import Model
    from repro_torch.models.transformer import init_params
    from perfbench.bench import model_config
    port = dict(conf["port"], dtype=dtype)
    cfg = model_config(dict(conf, port=port))
    model = Model(cfg, device="cpu").with_kernels(True)
    w = Weights(init_params(cfg, 0, device="meta"), "cpu", cfg.n_layers)
    w.fill(2**31 + 77)
    rng = np.random.default_rng(1)
    s, n_dec, slots = 13, 5, 3
    prompt = torch.tensor(rng.integers(1, cfg.vocab, (1, s)))
    cache = model.init_cache(slots, 32, per_slot_len=True)
    logits, cache = model.prefill_slot(w.params, {"tokens": prompt}, cache,
                                       1, cap=32)
    outs, seq = [logits[0, -1, :cfg.vocab].float()], prompt[0].tolist()
    live = torch.tensor([False, True, False])
    for _ in range(n_dec):
        seq.append(int(outs[-1].argmax()))
        tok = torch.tensor([[3], [seq[-1]], [5]])      # other rows decode too
        lg, cache = model.decode_step(w.params, tok, cache, live)
        outs.append(lg[1, 0, :cfg.vocab].float())
    positions = torch.arange(s - 1, s + n_dec)
    ref = Decoder(port, w.params).logits([torch.tensor(seq)],
                                         [positions])[0]
    low = Decoder(port, w.params, precision="fp8").logits(
        [torch.tensor(seq)], [positions])[0]
    return torch.stack(outs), ref, low


@pytest.mark.parametrize("conf", [GQA, MLA], ids=["gqa", "mla"])
def test_reference_matches_the_program_in_float32(conf):
    prog, ref, _ = _program_and_reference(conf, "float32")
    assert ref.shape == prog.shape
    assert float((prog - ref).abs().max()) < 2e-5 * float(ref.abs().max())


@pytest.mark.parametrize("conf", [GQA, MLA], ids=["gqa", "mla"])
def test_control_reads_farther_off_than_bf16(conf):
    prog, ref, low = _program_and_reference(conf, "bfloat16")
    bf16 = float((prog - ref).abs().mean())
    fp8 = float((low - ref).abs().mean())
    assert 0 < bf16 and 3 * bf16 < fp8


def test_gaps_of_served_tokens():
    ref = [torch.tensor([[0.0, 2.0, 1.0], [3.0, 0.5, 1.0]])]
    picked = [torch.tensor([1, 2])]
    gaps = check.gaps_of(ref, picked)
    assert [g.tolist() for g in gaps] == [[0.0, 2.0]]
    got = check.numbers(gaps + [torch.tensor([0.0, 0.0])])
    assert got["max_logit_gap"] == 2.0 and got["mean_logit_gap"] == 0.5
    assert got["per_request"] == [[2, 1.0, 2.0], [2, 0.0, 0.0]]


def test_judge_holds_each_number_to_its_limit():
    got = {"mean_logit_gap": 0.001, "max_logit_gap": None}
    compared = check.judge({"mean_logit_gap": 0.002}, got, failed=0)
    assert compared == {"mean_logit_gap": {"value": 0.001, "limit": 0.002},
                        "unfinished_requests": {"value": 0, "limit": 0}}
    assert check.passed(compared)
    assert not check.passed(check.judge({"mean_logit_gap": 0.002}, got, 1))
    assert not check.passed(check.judge({"mean_logit_gap": 0.0005}, got, 0))
    # a number with no reading fails
    assert not check.passed(check.judge({"max_logit_gap": 1.0}, got, 0))


def test_sequences_pad_as_the_engine_does():
    req = SimpleNamespace(prompt=np.array([5, 6, 7]), prompt_len=3,
                          tokens=[9, 8])
    seqs, pos, served = check.sequences([req], cap=64, device="cpu")
    assert seqs[0].tolist() == [0, 5, 6, 7, 9]        # pow2 pad to 4
    assert pos[0].tolist() == [3, 4] and served[0].tolist() == [9, 8]
