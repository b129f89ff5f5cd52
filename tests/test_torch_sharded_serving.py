"""Sharded serving on real ranks, against the unsharded model: four
``gloo`` ranks (spawned processes, a ``file://`` rendezvous under
``tmp_path``) on a (1, 4) (`data`, `model`) mesh whose `model` is split
over the kv heads (2 x 2, ``make_local_mesh(model=4, model_heads=2)``),
as the dry run splits it for a serving cell whose q heads divide
`model` and whose kv heads do not (``sharding.kv_heads_split``).

The smoke dense config with 8 q heads and 2 kv heads and a vocab of
1031, which does not divide `model`: the rules shard the tied embedding
on d, so the unembedding's logits are partial sums across `model` and
``Model.prefill`` / ``Model.decode_step`` reduce them (``pin_vocab``).
Each device projects the one kv head its q heads share and writes it
into its slice of a KV cache that holds the kv heads over "model_h"
(``carried_specs``), with no gather. A prompt of 12 tokens at batch 2 is
prefilled and 4 greedy steps decoded.

Tolerance: the prefill's and each step's logits within ``LOGITS_ATOL`` =
1e-5 of the unsharded model's (the reference's fp32 bound for logits;
the partial sums add in another order), greedy tokens equal, and the
gathered cache equal to the unsharded one within the same bound.
"""
import pytest
import torch
import torch.multiprocessing as mp
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.checkpoint.elastic import reshard_state
from repro_torch.configs import SMOKES
from repro_torch.configs.base import ShapeCell
from repro_torch.distributed.sharding import (MODEL_HEADS, cache_specs,
                                              carried_specs, kv_heads_split,
                                              param_specs, sanitize_tree)
from repro_torch.launch.mesh import make_local_mesh, process_group
from repro_torch.models.registry import build_model

LOGITS_ATOL = 1e-5
B, T, PROMPT, STEPS = 2, 32, 12, 4
CFG = SMOKES["qwen2-0.5b"].replace(n_heads=8, n_kv_heads=2, vocab_size=1031)


def _setup():
    """(model, params, prompt (B, PROMPT)); the model serves on the
    dry run's routes (masked attention), which DTensors take."""
    model = build_model(CFG, serve_kernels=False)
    params = model.init(torch.Generator().manual_seed(0), torch.float32,
                        device="cpu")
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, CFG.vocab_size, (B, PROMPT), generator=g)
    return model, params, prompt


def _serve(model, params, cache, prompt, place=lambda t: t,
           whole=lambda t: t):
    """Prefill ``prompt`` and decode ``STEPS`` greedy tokens: (the
    prefill's logits and each step's, the tokens, the cache, the
    placements of the returned logits)."""
    lg, cache = model.prefill(params, {"tokens": place(prompt)}, cache)
    layouts = [tuple(getattr(lg, "placements", ()))]
    out = [whole(lg)]
    tok = out[0][:, -1].argmax(-1)[:, None]
    toks = []
    for i in range(STEPS):
        lg, cache = model.decode_step(
            params, cache, {"tokens": place(tok), "cache_index": PROMPT + i})
        layouts.append(tuple(getattr(lg, "placements", ())))
        out.append(whole(lg))
        tok = out[-1][:, -1].argmax(-1)[:, None]
        toks.append(tok[:, 0].tolist())
    return out, toks, cache, layouts


def _worker(rank, world, root, out):
    torch.set_num_threads(1)
    with process_group("gloo", world, rank, f"file://{root}/rdv"):
        mesh = make_local_mesh(model=4, device="cpu",
                               model_heads=kv_heads_split(CFG, 4))
        model, params, prompt = _setup()
        cache = model.init_cache(B, T, device="cpu")
        cell = ShapeCell("serve", "decode", T, B)
        spec = carried_specs(sanitize_tree(
            cache, cache_specs(CFG, cell, mesh, cache), mesh), mesh)
        cache = reshard_state(cache, mesh, spec)
        params = reshard_state(params, mesh, param_specs(CFG, params, mesh))
        layout = tuple(cache[0].placements)
        rep = [Replicate()] * mesh.ndim
        logits, toks, cache, layouts = _serve(
            model, params, cache, prompt,
            place=lambda t: distribute_tensor(t, mesh, rep),
            whole=DTensor.full_tensor)
        kv = (cache[0].full_tensor(), cache[1].full_tensor())
    if rank == 0:
        torch.save({"mesh": mesh.mesh_dim_names, "layout": layout,
                    "logits": logits, "tokens": toks, "kv": kv,
                    "logit_layouts": layouts}, out)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    out = root / "res.pt"
    mp.spawn(_worker, args=(4, str(root), str(out)), nprocs=4, join=True)
    return torch.load(out, weights_only=False)


def test_cache_holds_its_kv_heads_over_model_h(sharded):
    """The cache (L, B, T, kv, hd) holds its 2 kv heads over "model_h",
    each on the 2 devices of "model_d" whose q heads share it."""
    assert kv_heads_split(CFG, 4) == 2
    assert sharded["mesh"] == ("data", MODEL_HEADS, "model_d")
    assert sharded["layout"] == (Replicate(), Shard(3), Replicate())


def test_logits_come_back_reduced(sharded):
    """No logits come back a pending partial sum: the vocab does not
    divide `model`, so they are whole there."""
    for pl in sharded["logit_layouts"]:
        assert pl and not any(isinstance(p, Partial) for p in pl)
        assert all(isinstance(p, Replicate) for p in pl[1:])


def test_sharded_serving_equals_unsharded(sharded):
    model, params, prompt = _setup()
    cache = model.init_cache(B, T, device="cpu")
    want, toks, cache, _ = _serve(model, params, cache, prompt)
    assert sharded["tokens"] == toks
    for got, lg in zip(sharded["logits"], want):
        assert got.shape == lg.shape
        assert float((got - lg).abs().max()) <= LOGITS_ATOL
    for got, c in zip(sharded["kv"], cache):
        assert float((got - c).abs().max()) <= LOGITS_ATOL
        assert float(got[:, :, PROMPT:PROMPT + STEPS].abs().max()) > 0
