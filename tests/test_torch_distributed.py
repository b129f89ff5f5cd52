"""Real sharding on the CPU: four ``gloo`` ranks (spawned processes, a
``file://`` rendezvous under ``tmp_path``) on a (2, 2) (`data`, `model`)
mesh take one training step, each from the same weights as the
unsharded step in this process:

- a smoke dense config on the masked-attention route and on "cp"
  (context-parallel chunked attention, S = 256), and the smoke moe config
  on the einsum experts;
- then the (2, 2) run saves a checkpoint through ``Checkpointer``, and
  two ranks restore it onto a (1, 2) mesh as ``plan_elastic_restart``
  and ``reshard_state`` say, and take the next step.

Tolerance: the loss within ``LOSS_RTOL`` = 1e-5 relative and every
updated parameter within ``PARAM_RTOL`` = 1e-5 of its leaf's largest
value (measured: losses within 7.7e-8, parameters equal; row-parallel
products sum their partial results in another order). Plus the
reference's elastic-plan cases, the ``reshard_state`` round trip on a
one-rank mesh, and "cp" against the reference's "cp" loss.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.checkpoint.elastic import plan_elastic_restart, reshard_state
from repro_torch.configs import SMOKES
from repro_torch.distributed.sharding import (P, batch_specs, param_specs,
                                              placements, state_specs)
from repro_torch.launch.mesh import make_local_mesh, process_group
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.models.registry import build_model

LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-5
B, S = 4, 256
RUNS = {"dense": ("qwen2-0.5b", False), "dense_cp": ("qwen2-0.5b", "cp"),
        "moe": ("qwen2-moe-a2.7b", False)}


def _batch(cfg, seed):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randint(0, cfg.vocab_size, (B, S), generator=g)
            for k in ("tokens", "targets")}


def _host_state(cfg, flash):
    model = build_model(cfg, use_flash=flash)
    return model, init_train_state(model, torch.Generator().manual_seed(0),
                                   device="cpu")


def _sharded_step(model, state, batch, mesh):
    cfg = model.cfg
    bs = batch_specs(cfg, "train", mesh)
    placed = {k: torch.distributed.tensor.distribute_tensor(
        v, mesh, placements(bs[k], mesh)) for k, v in batch.items()}
    state, m = make_train_step(model, peak_lr=1e-3, warmup=1)(state, placed)
    return state, float(m["loss"].full_tensor())


def _gathered(state):
    return {k: v.full_tensor().clone()
            for k, v in state["params"].named_parameters()}


def _worker(rank, world, root, out):
    torch.set_num_threads(1)
    res = {}
    with process_group("gloo", world, rank, f"file://{root}/rdv4"):
        mesh = make_local_mesh(model=2, device="cpu")
        for name, (arch, flash) in RUNS.items():
            cfg = SMOKES[arch]
            model, state = _host_state(cfg, flash)
            spec = state_specs(cfg, mesh, param_specs(cfg, state["params"],
                                                      mesh))
            state = reshard_state(state, mesh, spec)
            state, loss = _sharded_step(model, state, _batch(cfg, 1), mesh)
            shapes = {k: (tuple(v.to_local().shape), tuple(v.shape))
                      for k, v in state["params"].named_parameters()}
            res[name] = (loss, _gathered(state), shapes)
            if name == "dense":
                ck = Checkpointer(f"{root}/ckpt")
                ck.save(1, state, blocking=True)    # a collective: all ranks
                ck.wait()
    if rank >= 2:
        return
    # two ranks survive: rebuild the mesh the plan gives, restore, step
    plan = plan_elastic_restart(old_world=world, surviving=2,
                                model_parallel=2, global_batch=B,
                                last_step=1)
    with process_group("gloo", plan.new_world, rank,
                       f"file://{root}/rdv2"):
        mesh = make_local_mesh(model=2, device="cpu")
        cfg = SMOKES["qwen2-0.5b"]
        model, state = _host_state(cfg, False)
        state, step = Checkpointer(f"{root}/ckpt").restore(state)
        spec = state_specs(cfg, mesh, param_specs(cfg, state["params"], mesh))
        state = reshard_state(state, mesh, spec)
        _, loss = _sharded_step(model, state, _batch(cfg, 2), mesh)
        res["shrink"] = (loss, step, tuple(mesh.shape))
    if rank == 0:
        torch.save(res, out)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist")
    out = root / "res.pt"
    mp.spawn(_worker, args=(4, str(root), str(out)), nprocs=4, join=True)
    return torch.load(out)


def _unsharded(name, steps=1):
    arch, flash = RUNS[name]
    cfg = SMOKES[arch]
    model, state = _host_state(cfg, flash)
    losses = []
    for i in range(steps):
        state, m = make_train_step(model, peak_lr=1e-3, warmup=1)(
            state, _batch(cfg, 1 + i))
        losses.append(float(m["loss"]))
    return losses, state


@pytest.mark.parametrize("name", list(RUNS))
def test_sharded_step_equals_unsharded(sharded, name):
    loss, params, shapes = sharded[name]
    (want,), state = _unsharded(name)
    assert loss == pytest.approx(want, rel=LOSS_RTOL)
    for k, v in state["params"].named_parameters():
        scale = float(v.detach().abs().max()) or 1.0
        assert float((params[k] - v).abs().max()) <= PARAM_RTOL * scale, k
    # the rules really shard: some parameter is smaller on each rank
    assert any(local != full for local, full in shapes.values())


def test_elastic_shrink_resumes(sharded):
    """(2, 2) -> checkpoint -> (1, 2): the next loss is the unsharded
    continuation's."""
    loss, step, shape = sharded["shrink"]
    assert step == 1 and shape == (1, 2)
    losses, _ = _unsharded("dense", steps=2)
    assert loss == pytest.approx(losses[1], rel=LOSS_RTOL)


# ---- the reference's test_train.py elastic cases ----
def test_elastic_plan():
    p = plan_elastic_restart(old_world=512, surviving=384,
                             model_parallel=16, global_batch=256,
                             last_step=1000)
    # 384/16 = 24 data shards, but 256 % 24 != 0 -> shrink to 16
    assert p.new_data_axis == 16
    assert p.new_world == 256
    assert 256 % p.new_data_axis == 0
    assert p.restart_step == 1000
    # exact-fit case
    p2 = plan_elastic_restart(512, 256, 16, 256, 0)
    assert p2.new_data_axis == 16
    with pytest.raises(RuntimeError, match="cannot rebuild"):
        plan_elastic_restart(512, 8, 16, 256, 0)


def test_reshard_state_roundtrip():
    with process_group("gloo"):
        mesh = make_local_mesh(device="cpu")
        state = {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4)}
        placed = reshard_state(state, mesh, {"w": P(None, None)})
        assert torch.equal(placed["w"].full_tensor(), state["w"])
        placed = reshard_state(state, mesh, {"w": P("data", "model")})
        assert torch.equal(placed["w"].full_tensor(), state["w"])
    assert not dist.is_initialized()


def test_process_groups_do_not_stay_alive():
    with process_group("fake", 256):
        with pytest.raises(RuntimeError, match="already alive"):
            with process_group("gloo"):
                pass
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="needs a running process group"):
        make_local_mesh(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_local_mesh()


# ---- "cp" against the reference ----
def test_cp_loss_matches_the_reference():
    """``Model.loss`` with "cp" at S = 256 (the chunked route) equals the
    reference's "cp" loss under its local mesh; off a mesh the port's
    constraint is identity, so it equals the port's chunked loss too.
    Tolerance: the training parity tests' 1e-5 relative."""
    from repro.configs import SMOKES as J_SMOKES
    from repro.launch.mesh import make_local_mesh as j_make_local_mesh
    from repro.models.registry import build_model as j_build_model
    from repro_torch.convert import params_from_jax

    cfg, jcfg = SMOKES["qwen2-0.5b"], J_SMOKES["qwen2-0.5b"]
    jm = j_build_model(jcfg, use_flash="cp")
    jp = jm.init(jax.random.PRNGKey(0), jnp.float32)
    batch = {k: v.numpy().astype(np.int32) for k, v in _batch(cfg, 3).items()}
    with j_make_local_mesh():
        ref, _ = jax.jit(jm.loss)(jp, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    params = params_from_jax(cfg, jp, device="cpu")
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    ours, _ = build_model(cfg, use_flash="cp").loss(params, tb)
    chunked, _ = build_model(cfg, use_flash=True).loss(params, tb)
    assert float(ours) == pytest.approx(float(ref), rel=1e-5)
    assert torch.equal(ours, chunked)
