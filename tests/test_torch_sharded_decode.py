"""A batch-1 decode over a KV cache sharded on its sequence, on real
ranks: four ``gloo`` ranks (spawned processes, a ``file://`` rendezvous
under ``tmp_path``) on a (2, 2) (`data`, `model`) mesh, against the
unsharded decode in this process from the same weights.

The smoke Zamba2 config at batch 1 with a cache of 64 positions: the
rules (``cache_specs``) shard a batch-1 cache 2 ways on its sequence
over `data` and its kv heads over `model`. A prompt of 29 tokens is
prefilled unsharded; the KV caches and the Mamba2 states are then
placed by the rules, and 6 greedy steps decode at positions 29 to 34,
across the border of the two slices at 32. Each rank scores q against
its own slice of the cache and the softmax is combined across `data`
(``sharding.seq_on_shards``); the new key and value are written by the
ranks whose slice holds their position, and by no other
(``sharding.write_at``).

Left to DTensor, the in-place write of a decode step gathered the cache
and wrote into the gathered copy, so the sharded cache never took the
new key.

Tolerance: each step's logits within ``LOGITS_ATOL`` = 1e-5 of the
unsharded step's (the reference's fp32 bound for logits; the combine
sums the two slices' softmax parts in another order), greedy tokens
equal, and the gathered cache equal to the unsharded one within the
same bound.
"""
import pytest
import torch
import torch.multiprocessing as mp
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.checkpoint.elastic import reshard_state
from repro_torch.configs import SMOKES
from repro_torch.configs.base import ShapeCell
from repro_torch.distributed.sharding import (cache_specs, param_specs,
                                              sanitize_tree)
from repro_torch.launch.mesh import make_local_mesh, process_group
from repro_torch.models.registry import build_model

LOGITS_ATOL = 1e-5
T, PROMPT, STEPS = 64, 29, 6


def _setup():
    """(cfg, model, params, the cache after the prompt's prefill, the
    first greedy token (1, 1))."""
    cfg = SMOKES["zamba2-7b"]
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), torch.float32,
                        device="cpu")
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT), generator=g)
    cache = model.init_cache(1, T, device="cpu")
    logits, cache = model.prefill(params, {"tokens": prompt}, cache)
    return cfg, model, params, cache, logits[:, -1].argmax(-1)[:, None]


def _decode(model, params, cache, tok, place=lambda t: t,
            whole=lambda t: t):
    """``STEPS`` greedy decode steps: (the logits of each, the tokens)."""
    out, toks = [], []
    for i in range(STEPS):
        lg, cache = model.decode_step(
            params, cache, {"tokens": place(tok), "cache_index": PROMPT + i})
        lg = whole(lg)
        tok = lg[:, -1].argmax(-1)[:, None]
        out.append(lg)
        toks.append(int(tok))
    return out, toks, cache


def _worker(rank, world, root, out):
    torch.set_num_threads(1)
    with process_group("gloo", world, rank, f"file://{root}/rdv"):
        mesh = make_local_mesh(model=2, device="cpu")
        cfg, model, params, cache, tok = _setup()
        cell = ShapeCell("decode_b1", "decode", T, 1)
        spec = sanitize_tree(cache, cache_specs(cfg, cell, mesh, cache), mesh)
        cache = reshard_state(cache, mesh, spec)
        params = reshard_state(params, mesh, param_specs(cfg, params, mesh))
        layout = tuple(cache["kv_k"].placements)
        logits, toks, cache = _decode(
            model, params, cache, tok,
            place=lambda t: distribute_tensor(t, mesh,
                                              [Replicate(), Replicate()]),
            whole=DTensor.full_tensor)
        kv = (cache["kv_k"].full_tensor(), cache["kv_v"].full_tensor())
    if rank == 0:
        torch.save({"layout": layout, "logits": logits, "tokens": toks,
                    "kv": kv}, out)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    root = tmp_path_factory.mktemp("decode")
    out = root / "res.pt"
    mp.spawn(_worker, args=(4, str(root), str(out)), nprocs=4, join=True)
    return torch.load(out)


def test_cache_is_sharded_on_its_sequence(sharded):
    """The rules' layout of the batch-1 cache (n_attn, 1, T, kv, hd):
    the sequence over `data`, the kv heads over `model`."""
    assert sharded["layout"] == (Shard(2), Shard(3))


def test_sequence_sharded_decode_equals_unsharded(sharded):
    _, model, params, cache, tok = _setup()
    want, toks, cache = _decode(model, params, cache, tok)
    assert sharded["tokens"] == toks
    for got, lg in zip(sharded["logits"], want):
        assert float((got - lg).abs().max()) <= LOGITS_ATOL
    for got, c in zip(sharded["kv"], (cache["kv_k"], cache["kv_v"])):
        assert float((got - c).abs().max()) <= LOGITS_ATOL
        assert float(got[:, :, PROMPT:PROMPT + STEPS].abs().max()) > 0
