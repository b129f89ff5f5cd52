"""Gradients of a sharded loss against the unsharded ones: four ``gloo``
ranks (spawned processes, a ``file://`` rendezvous under ``tmp_path``)
on a (2, 2) (`data`, `model`) mesh take ``Model.loss`` and its gradient
with respect to every parameter, each from the same weights and batch as
the unsharded loss in this process:

- a smoke dense config on the masked-attention route and on "cp";
- the same with one kv head, so the q heads divide `model` and the kv
  heads do not (each device projects the kv head its q heads share);
- the smoke moe config on the einsum experts (its load-balancing loss
  averages over the data shards);
- the dense config with 3 q heads and 1 kv head, which do not divide
  `model` (attention replicated there, its projections split to follow
  the residual stream), with a vocab of 511, which does not divide it
  (the table, the residual stream and the unembedding sharded on d),
  and with both;
- the smoke Zamba2 config (the SSD on each device's heads, B and C
  shared by all of them) and the smoke xLSTM config (the sLSTM scan on
  each device's batch rows and units, the mLSTM on each device's
  heads);
- the smoke xLSTM config with heads that do not cover `model`, on a
  mesh whose `model` is split over them (``MESHES``): 1 head on a
  `model` of 2 ((2, 1, 2) (`data`, `model_h`, `model_d`)) and 2 heads on
  a `model` of 4 ((1, 2, 2)). Each head then spans 2 devices: the mLSTM
  runs on (head, head-dim) shards, its matrix memory's contraction over
  n a partial sum within the head, and the sLSTM trades its gates by
  all-to-all each step and gathers its head's h. (Before, the heads
  were gathered and both ran whole on every device: the same numbers,
  which this test cannot tell apart; ``tests/test_torch_dryrun.py``
  holds the layout.)

A training step's parameters (``tests/test_torch_distributed.py``)
cannot tell a gradient from a multiple of it: AdamW's first step moves
each parameter by the learning rate times the gradient's sign.

Tolerance: the loss within ``LOSS_RTOL`` = 1e-5 relative and every
gradient within ``GRAD_RTOL`` = 1e-5 of its leaf's largest value
(measured: losses within 7.7e-8, gradients within 3.5e-6; row-parallel
products and the batch's reductions sum in another order); Zamba2's
gradients within ``GRAD_RTOLS`` = 1e-4 (measured 2.4e-5, see there; a
device's B and C gradient taken as whole instead of a partial sum over
`model` is off by 0.5).
"""
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.checkpoint.elastic import reshard_state
from repro_torch.configs import SMOKES
from repro_torch.distributed.sharding import (batch_specs, param_specs,
                                              placements, replicate_plain,
                                              state_specs)
from repro_torch.launch.mesh import make_local_mesh, process_group
from repro_torch.launch.steps import init_train_state
from repro_torch.models.registry import build_model

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
B, S = 4, 256
RUNS = {"dense": ("qwen2-0.5b", False, {}),
        "dense_cp": ("qwen2-0.5b", "cp", {}),
        "one_kv_head": ("qwen2-0.5b", False, {"n_kv_heads": 1}),
        "moe": ("qwen2-moe-a2.7b", False, {}),
        "odd_heads": ("qwen2-0.5b", False, {"n_heads": 3, "n_kv_heads": 1}),
        "odd_vocab": ("qwen2-0.5b", False, {"vocab_size": 511}),
        "odd_vocab_untied": ("qwen2-0.5b", False,
                             {"vocab_size": 511, "tie_embeddings": False}),
        "odd_heads_vocab": ("qwen2-0.5b", False,
                            {"n_heads": 3, "n_kv_heads": 1,
                             "vocab_size": 511}),
        "zamba2": ("zamba2-7b", False, {}),
        "xlstm": ("xlstm-350m", False, {}),
        "xlstm_one_head": ("xlstm-350m", False,
                           {"n_heads": 1, "n_kv_heads": 1}),
        "xlstm_two_heads": ("xlstm-350m", False,
                            {"n_heads": 2, "n_kv_heads": 2})}
# (`model`, the heads `model` is split over) of a run's mesh; the rest
# run on a (2, 2) (`data`, `model`) mesh
MESHES = {"xlstm_one_head": (2, 1), "xlstm_two_heads": (4, 2)}
# Zamba2's SSD sums in fp32 whatever the weights' dtype: its A_log, B
# and C gradients differ by up to 2.4e-5 between the head-split order of
# sums and the whole one (3e-14 with the SSD in float64 too)
GRAD_RTOLS = {"zamba2": 1e-4}


def _setup(name):
    arch, flash, cut = RUNS[name]
    cfg = SMOKES[arch].replace(**cut)
    model = build_model(cfg, use_flash=flash)
    state = init_train_state(model, torch.Generator().manual_seed(0),
                             device="cpu")
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=g)
             for k in ("tokens", "targets")}
    return cfg, model, state, batch


def _loss_and_grads(model, params, batch):
    named = dict(params.named_parameters())
    with replicate_plain(params):
        loss, _ = model.loss(params, batch)
        grads = torch.autograd.grad(loss, list(named.values()))
    return loss, dict(zip(named, grads))


def _worker(rank, world, root, out):
    torch.set_num_threads(1)
    res = {}
    with process_group("gloo", world, rank, f"file://{root}/rdv"):
        for name in RUNS:
            model_size, heads = MESHES.get(name, (2, 0))
            mesh = make_local_mesh(model=model_size, device="cpu",
                                   model_heads=heads)
            cfg, model, state, batch = _setup(name)
            spec = state_specs(cfg, mesh, param_specs(cfg, state["params"],
                                                      mesh))
            state = reshard_state(state, mesh, spec)
            bs = batch_specs(cfg, "train", mesh)
            placed = {k: torch.distributed.tensor.distribute_tensor(
                v, mesh, placements(bs[k], mesh)) for k, v in batch.items()}
            loss, grads = _loss_and_grads(model, state["params"], placed)
            res[name] = (float(loss.full_tensor()),
                         {k: g.full_tensor() for k, g in grads.items()})
    if rank == 0:
        torch.save(res, out)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    root = tmp_path_factory.mktemp("grads")
    out = root / "res.pt"
    mp.spawn(_worker, args=(4, str(root), str(out)), nprocs=4, join=True)
    return torch.load(out)


@pytest.mark.parametrize("name", list(RUNS))
def test_sharded_gradients_equal_unsharded(sharded, name):
    loss, grads = sharded[name]
    _, model, state, batch = _setup(name)
    want_loss, want = _loss_and_grads(model, state["params"], batch)
    assert loss == pytest.approx(float(want_loss), rel=LOSS_RTOL)
    for k, g in want.items():
        scale = float(g.abs().max()) or 1.0
        rtol = GRAD_RTOLS.get(name, GRAD_RTOL)
        assert float((grads[k] - g).abs().max()) <= rtol * scale, k
