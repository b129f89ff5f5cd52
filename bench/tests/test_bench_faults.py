"""A run with the timed path broken underneath comes out not correct:
the harness's whole run (set-up, window, check of outputs) on the CPU,
for each of ``BENCHMARK.json``'s cells and each fault that the cell can
have. A cell runs here with its family's tiny sizes and its own mix cut
to short prompts (rows, cycle counts and new tokens kept), and is held
to its own ``limits/<cell>.json``: the same sample and the same numbers
and limits as on the card. (The cells run on one chip, so there is no
exchange between chips to leave out.)"""
from __future__ import annotations

import json
import time

import pytest

from bench import harness
from bench.manifest import Manifest
from bench.tests.conftest import write_layout

CELLS = Manifest().workloads()
SHORTER = 64        # the mix's prompt lengths divided by this


def _run(tmp_path, cell: str):
    real = Manifest().cell(cell)
    mix = dict(real.mix)
    mix["cycle"] = [[max(4, int(S) // SHORTER), n] for S, n in mix["cycle"]]
    mix["max_seq"] = max(S for S, _ in mix["cycle"]) + int(mix["n_new"])
    name = write_layout(tmp_path, real.config["family"], mix)
    (tmp_path / "bench" / "limits" / f"{name}.json").write_text(
        json.dumps(real.limits))
    return harness.run_cell(Manifest(tmp_path), name, seed=12345,
                            seconds=0.01, trace=False, device="cpu",
                            t0=time.perf_counter()), real.limits


def _compared_fail(out, limits) -> bool:
    """Some number that the cell compares is over its limit."""
    return any(out.checks[n]["value"] > out.checks[n]["limit"]
               for n in limits["limits"])


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tmp_path, cell):
    out, limits = _run(tmp_path, cell)
    assert harness.correct(out), out.checks
    assert out.checks.keys() >= limits["limits"].keys()
    assert out.gaps and max(out.gaps) < 1e-4


def _token_altered(monkeypatch, n_new: int):
    """A token altered where it is produced: at one step in every
    ``n_new`` (each request's only one where it asks for one) every
    row's token is not the greedy one."""
    from repro_torch.serve.engine import ServeEngine

    real = ServeEngine._sample
    calls = {"n": 0}
    at = min(1, n_new - 1)

    def sample(logits, generator, temperature):
        nxt = real(logits, generator, temperature)
        if calls["n"] % n_new == at:
            nxt = (nxt + 1) % logits.shape[-1]
        calls["n"] += 1
        return nxt

    monkeypatch.setattr(ServeEngine, "_sample", staticmethod(sample))


def _state_unchanged(monkeypatch, n_new: int):
    """A decode step that returns its state unchanged: its keys and
    values never reach the cache."""
    from repro_torch.models.registry import Model

    real = Model.decode_step

    def step(self, params, cache, batch):
        lg, _ = real(self, params, tuple(c.clone() for c in cache), batch)
        return lg, cache

    monkeypatch.setattr(Model, "decode_step", step)


def _half_batch(monkeypatch, n_new: int):
    """Half of the batch left out: the first half is served and its
    tokens stand in for the other half's."""
    import numpy as np

    from repro_torch.serve.engine import ServeEngine

    real = ServeEngine.generate

    def generate(self, prompt_tokens, n_new, *a, **kw):
        half = prompt_tokens.shape[0] // 2
        res = real(self, prompt_tokens[:half], n_new, *a, **kw)
        res.tokens = np.concatenate([res.tokens, res.tokens])
        return res

    monkeypatch.setattr(ServeEngine, "generate", generate)


def _faults():
    """(cell, fault) for each fault the cell can have: a cell whose
    requests take one new token serves it from the prefill, so no decode
    step's state reaches a served token there."""
    out = []
    for cell in CELLS:
        n_new = int(Manifest().cell(cell).mix["n_new"])
        for fault in (_token_altered, _state_unchanged, _half_batch):
            if fault is _state_unchanged and n_new == 1:
                continue
            out.append(pytest.param(cell, fault,
                                    id=f"{cell}-{fault.__name__[1:]}"))
    return out


@pytest.mark.parametrize("cell,fault", _faults())
def test_fault_is_not_correct(tmp_path, monkeypatch, cell, fault):
    fault(monkeypatch, int(Manifest().cell(cell).mix["n_new"]))
    out, limits = _run(tmp_path, cell)
    assert not harness.correct(out), out.checks
    assert _compared_fail(out, limits), out.checks
