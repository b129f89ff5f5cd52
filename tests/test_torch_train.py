"""The port's training path (``models`` training half, ``optim``,
``launch.steps``, ``distributed.{compress,fault}``, ``data.pipeline``,
``checkpoint``, ``train.loop``) on the CPU: the reference's own training
tests (``tests/test_train.py``, bar the two elastic ones, which wait for
the distribution slice), then parity with the reference on the same
inputs, and checkpoints that each package restores from the other. The
step-0 loss, gradient and loss-curve parity is in
``test_torch_train_parity.py``.

Tolerances (fp32):
- AdamW and the schedules: 1e-6 relative (for AdamW, of each leaf's
  largest value), a few fp32 ulp: the global norm is summed in another
  order, and XLA's and torch's exp differ by an ulp;
- ``quantize_ef``: equal;
- ``_sdpa_chunked``: 1e-5.
"""
import json
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as j_ckpt
from repro.configs import SMOKES as J_SMOKES
from repro.data.pipeline import SyntheticLMData as JData
from repro.distributed.compress import quantize_ef as j_quantize_ef
from repro.distributed.fault import StragglerMonitor as JMonitor
from repro.launch.steps import init_train_state as j_init_train_state
from repro.models import layers as JL
from repro.models.registry import build_model as j_build_model
from repro.optim.adamw import adamw_init as j_adamw_init
from repro.optim.adamw import adamw_update as j_adamw_update
from repro.optim.schedule import cosine_schedule as j_cosine
from repro.optim.schedule import wsd_schedule as j_wsd
from repro_torch.checkpoint.checkpointer import (
    Checkpointer, list_checkpoints, restore_checkpoint, save_checkpoint)
from repro_torch.checkpoint.checkpointer import _flatten as ckpt_flatten
from repro_torch.checkpoint.codec import packb, unpackb
from repro_torch.configs import SMOKES
from repro_torch.convert import (_flatten, load_state_,
                                 params_from_jax, params_to_jax, state_to_jax)
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.distributed.compress import (
    compress_tree, decompress_tree, init_residuals, quantize_ef)
from repro_torch.distributed.fault import StragglerMonitor
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.models import layers as TL
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.schedule import cosine_schedule, wsd_schedule
from repro_torch.train.loop import TrainConfig, train

CFG = SMOKES["qwen2-0.5b"]
ARCHS = list(SMOKES)
TOL = 1e-5
OPT_RTOL = 1e-6
QUIET = dict(log_fn=lambda *_: None)


def _cpu(**kw):
    return TrainConfig(device="cpu", log_every=100, **kw)


# ----------------------------------------------------------------------
# tests/test_train.py, on the port
# ----------------------------------------------------------------------
def test_loss_decreases():
    out = train(CFG, _cpu(steps=12, batch=4, seq=64, peak_lr=1e-3,
                          warmup=2), **QUIET)
    first = np.mean(out["losses"][:3])
    last = np.mean(out["losses"][-3:])
    assert last < first - 0.1, (first, last)


def test_checkpoint_resume_is_exact(tmp_path):
    """train(6) == train(3) + crash + resume(3): identical losses."""
    tc = dict(batch=2, seq=32, peak_lr=5e-4, warmup=2)
    full = train(CFG, _cpu(steps=6, **tc), **QUIET)
    d = str(tmp_path / "ck")
    train(CFG, _cpu(steps=3, ckpt_dir=d, ckpt_every=3, **tc), **QUIET)
    resumed = train(CFG, _cpu(steps=6, ckpt_dir=d, ckpt_every=3, **tc),
                    **QUIET)
    np.testing.assert_allclose(full["losses"][3:], resumed["losses"],
                               rtol=1e-5)


def test_checkpoint_integrity_and_retention(tmp_path):
    d = str(tmp_path / "ck")
    state = {"a": torch.arange(8, dtype=torch.float32),
             "b": {"c": torch.ones((3, 3), dtype=torch.bfloat16)}}
    ck = Checkpointer(d, keep=2)
    for s in (1, 2, 3):
        ck.save(s, state, blocking=True)
    assert list_checkpoints(d) == [2, 3]
    restored, step = restore_checkpoint(d, state)
    assert step == 3
    np.testing.assert_array_equal(restored["a"].numpy(),
                                  np.arange(8, dtype=np.float32))
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(restored["b"]["c"], state["b"]["c"])
    # a corrupted payload fails the manifest's hash
    with open(os.path.join(d, "step_00000003", "arrays.msgpack"), "r+b") as f:
        f.seek(-1, os.SEEK_END)
        last = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([last[0] ^ 1]))
    with pytest.raises(IOError, match="integrity"):
        restore_checkpoint(d, state)


def test_checkpoint_atomic_under_partial_write(tmp_path):
    d = str(tmp_path / "ck")
    state = {"w": torch.ones((4,))}
    save_checkpoint(d, 1, state)
    # simulate a crash mid-save: stray tmp dir must be ignored
    os.makedirs(os.path.join(d, "step_00000002.tmp"))
    restored, step = restore_checkpoint(d, state)
    assert step == 1


def test_async_save_surfaces_errors(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = Checkpointer(str(blocker))
    ck.save(1, {"w": torch.ones(2)})
    with pytest.raises(OSError):
        ck.wait()


def test_quantize_error_feedback_unbiased():
    """With error feedback, accumulated dequantized grads converge to
    the true gradient sum."""
    g = torch.randn(256, generator=torch.Generator().manual_seed(0)) * 0.01
    resid = torch.zeros_like(g)
    acc = torch.zeros_like(g)
    for _ in range(50):
        q, scale, resid = quantize_ef(g, resid)
        acc = acc + q.float() * scale
    np.testing.assert_allclose((acc / 50).numpy(), g.numpy(), atol=1e-4)


def test_compress_tree_roundtrip_small_error():
    gen = torch.Generator().manual_seed(1)
    grads = {"w": torch.randn(32, 32, generator=gen),
             "b": torch.randn(32, generator=gen) * 10}
    resids = init_residuals(grads)
    q, s, r = compress_tree(grads, resids)
    out = decompress_tree(q, s)
    for k in grads:
        assert q[k].dtype == torch.int8 and r[k].shape == grads[k].shape
        err = (out[k] - grads[k]).abs().max()
        scale = grads[k].abs().max()
        assert err <= scale / 127 * 1.01


def _straggler_script(mon):
    seen = []
    for step in range(6):
        for h in range(4):
            mon.observe(step, h, 1.0 if h != 3 else 3.0)  # host 3 is slow
        mon.stragglers()
    seen.append(mon.stragglers())
    # host 2 stops heartbeating; host 3 stays slow
    for step in range(6, 20):
        for h, t in ((0, 1.0), (1, 1.0), (3, 3.0)):
            mon.observe(step, h, t)
        mon.stragglers()
    seen += [mon.failed(19), set(mon.healthy_hosts(19))]
    # a recovered straggler is healthy again
    for step in range(20, 30):
        for h in (0, 1, 3):
            mon.observe(step, h, 1.0)
        mon.stragglers()
    seen.append(set(mon.healthy_hosts(29)))
    return seen


def test_straggler_monitor():
    seen = _straggler_script(StragglerMonitor(n_hosts=4, threshold=1.5,
                                              grace=2))
    assert seen[0] == {3}
    assert 2 in seen[1]
    assert seen[2] == {0, 1}
    assert 3 in seen[3]
    assert seen == _straggler_script(JMonitor(n_hosts=4, threshold=1.5,
                                              grace=2))


# ----------------------------------------------------------------------
# every family trains on the CPU; routes
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_train_every_family_on_cpu(arch):
    out = train(SMOKES[arch], _cpu(steps=3, batch=2, seq=32, peak_lr=1e-3,
                                   warmup=1), **QUIET)
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert len(out["step_s"]) == 3
    assert all(p.requires_grad for p in out["state"]["params"].parameters())
    assert int(out["state"]["step"]) == 3


@pytest.mark.parametrize("use_flash", ["cp", "pallas"])
def test_training_refuses_routes_without_a_port(use_flash):
    """"pallas" has no training route (the kernel has no backward). "cp"
    has one since the distribution slice: off a mesh its constraint is
    identity, so it is the chunked route (at S >= 256)."""
    m = build_model(CFG, use_flash=use_flash)
    st = init_train_state(m, torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": torch.zeros(1, 256, dtype=torch.long),
             "targets": torch.zeros(1, 256, dtype=torch.long)}
    if use_flash == "cp":
        loss, _ = m.loss(st["params"], batch)
        chunked, _ = build_model(CFG, use_flash=True).loss(st["params"],
                                                           batch)
        assert torch.equal(loss, chunked)
        return
    with pytest.raises(ValueError, match="no training route"):
        m.loss(st["params"], batch)


def test_serving_keeps_its_return_values():
    """prefill / decode_step still return (logits, cache)."""
    m = build_model(CFG)
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    cache = m.init_cache(1, 16, device="cpu")
    with torch.inference_mode():
        out = m.prefill(p, {"tokens": torch.zeros(1, 4, dtype=torch.long)},
                        cache)
        assert len(out) == 2 and out[1] is cache
        out = m.decode_step(p, cache, {"tokens": torch.zeros(
            1, 1, dtype=torch.long), "cache_index": 4})
        assert len(out) == 2 and out[1] is cache


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "zamba2-7b"])
def test_remat_changes_no_value(arch):
    """Checkpointed layers recompute the same loss and gradients."""
    cfg = SMOKES[arch]
    batch = _batch(arch, 2, 32)
    out = []
    for remat in (False, True):
        m = build_model(cfg, remat=remat)
        st = init_train_state(m, torch.Generator().manual_seed(0),
                              device="cpu")
        loss, _ = m.loss(st["params"], batch)
        g = torch.autograd.grad(loss, list(st["params"].parameters()))
        out.append((loss, g))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ----------------------------------------------------------------------
# parity with the reference
# ----------------------------------------------------------------------
def _batch(arch, B, S, seed=3):
    b = JData(J_SMOKES[arch], B, S, seed=seed).sample(0)
    return {k: torch.from_numpy(v).long() if k != "patch_embeds"
            else torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("S", [200, 512, 700])
def test_sdpa_chunked_matches_reference(S):
    rng = np.random.default_rng(S)
    q = rng.standard_normal((2, S, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, S, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, S, 2, 16)).astype(np.float32)
    want = JL._sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            chunk=256)
    got = TL._sdpa_chunked(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), chunk=256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_adamw_matches_reference():
    rng = np.random.default_rng(0)
    shapes = {"a": (64, 32), "b/c": (32,), "d": (3, 5, 7)}
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    js = j_adamw_init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    ts = adamw_init(tp)
    for i in range(4):
        # the last step's gradient is large enough to be clipped
        g = {k: rng.standard_normal(s).astype(np.float32) * (10 ** i)
             for k, s in shapes.items()}
        lr = 1e-2 * (i + 1)
        jp, js = j_adamw_update(jp, {k: jnp.asarray(v) for k, v in g.items()},
                                js, jnp.float32(lr))
        tp, ts = adamw_update(tp, {k: torch.from_numpy(v)
                                   for k, v in g.items()},
                              ts, torch.tensor(lr))
        assert int(ts["step"]) == int(js["step"]) == i + 1
        assert ts["step"].dtype == torch.int32
        for k in shapes:
            for got, want in ((tp[k], jp[k]), (ts["m"][k], js["m"][k]),
                              (ts["v"][k], js["v"][k])):
                # an ulp of the update lands on entries near 0 too
                want = np.asarray(want)
                assert got.dtype == torch.float32
                np.testing.assert_allclose(
                    got.numpy(), want, rtol=OPT_RTOL,
                    atol=OPT_RTOL * float(np.abs(want).max()))


def test_adamw_moments_are_fp32_for_bf16_params():
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    st = adamw_init(p)
    assert st["m"]["w"].dtype == st["v"]["w"].dtype == torch.float32
    adamw_update(p, {"w": torch.ones(4, dtype=torch.bfloat16)}, st,
                 torch.tensor(1e-2))
    assert p["w"].dtype == torch.bfloat16 and (p["w"] < 1).all()


def test_schedules_match_reference():
    steps = range(0, 140, 3)
    for j_fn, t_fn, args in ((j_wsd, wsd_schedule, (3e-4, 20, 80, 30)),
                             (j_cosine, cosine_schedule, (3e-4, 20, 100))):
        want = np.array([float(j_fn(s, *args)) for s in steps])
        got = torch.stack([t_fn(torch.tensor(s, dtype=torch.int32), *args)
                           for s in steps])
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=OPT_RTOL, atol=0)


def test_quantize_ef_equals_reference():
    rng = np.random.default_rng(0)
    g = rng.standard_normal(4096).astype(np.float32) * 0.01
    r = rng.standard_normal(4096).astype(np.float32) * 1e-4
    # max |g| = 127 makes the scale 1.0, so these are exact ties
    g[:6], r[:6] = [127.0, 0.5, -0.5, 1.5, 2.5, -2.5], 0.0
    jq, js, jr = j_quantize_ef(jnp.asarray(g), jnp.asarray(r))
    tq, ts, tr = quantize_ef(torch.from_numpy(g), torch.from_numpy(r))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert float(ts) == 1.0
    assert tq[:6].tolist() == [127, 0, 0, 2, 2, -2]   # half to even


def test_data_pipeline_equals_reference():
    for arch in ("qwen2-0.5b", "musicgen-large", "internvl2-1b"):
        a = JData(J_SMOKES[arch], 4, 24, seed=5, shard=1, n_shards=2)
        b = SyntheticLMData(SMOKES[arch], 4, 24, seed=5, shard=1, n_shards=2)
        for step in (0, 7):
            want, got = a.sample(step), b.sample(step)
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])


def test_batch_shapes_equal_reference():
    for arch in ARCHS:
        jm, tm = j_build_model(J_SMOKES[arch]), build_model(SMOKES[arch])
        for kind in ("train", "prefill", "decode"):
            want = jm.batch_shapes(kind, 2, 300)
            got = tm.batch_shapes(kind, 2, 300)
            assert got.keys() == want.keys()
            for k in want:
                assert got[k][0] == want[k][0]
                assert str(got[k][1]).removeprefix("torch.") == \
                    np.dtype(want[k][1]).name


def _ref_state(arch, seed=1):
    jm = j_build_model(J_SMOKES[arch])
    return jm, j_init_train_state(jm, jax.random.PRNGKey(seed))


def _port_state_from(arch, jstate):
    """A port training state holding the reference state's values."""
    tm = build_model(SMOKES[arch])
    st = init_train_state(tm, torch.Generator().manual_seed(9), device="cpu")
    return tm, load_state_(st, jax.tree.map(np.asarray, jstate))


# ----------------------------------------------------------------------
# checkpoints: the codec, and both packages restoring each other's
# ----------------------------------------------------------------------
def test_codec_is_byte_identical_to_msgpack():
    objs = [0, 127, 128, 2 ** 16, 2 ** 40, -1, -33, -2 ** 40, "", "k" * 40,
            "é" * 300, b"", b"x" * 300, b"y" * 70000, [], [1] * 20,
            {f"k{i}": [i, -i, str(i)] for i in range(20)},
            {"w": {"dtype": "float32", "shape": [],
                   "data": np.float32(1.5).tobytes()}}]
    def norm(x):   # bins come back as memoryviews
        if isinstance(x, memoryview):
            return bytes(x)
        if isinstance(x, list):
            return [norm(v) for v in x]
        if isinstance(x, dict):
            return {k: norm(v) for k, v in x.items()}
        return x

    for o in objs:
        blob = packb(o)
        assert blob == msgpack.packb(o)
        assert norm(unpackb(bytearray(blob))) == msgpack.unpackb(blob)
    for bad in (1.5, None, True):
        with pytest.raises(TypeError):
            packb(bad)


def test_checkpoint_bytes_equal_reference(tmp_path):
    """The port's arrays.msgpack of a training state is the reference
    checkpointer's file of the same state, byte for byte, and
    ``msgpack.packb`` of its payload."""
    arch = "xlstm-350m"
    _, js = _ref_state(arch)
    _, ts = _port_state_from(arch, js)
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    j_ckpt.save_checkpoint(str(jdir), 3, js)
    save_checkpoint(str(tdir), 3, ts)
    jb = (jdir / "step_00000003" / "arrays.msgpack").read_bytes()
    tb = (tdir / "step_00000003" / "arrays.msgpack").read_bytes()
    assert tb == jb
    payload = {k: {"dtype": str(v.dtype).removeprefix("torch."),
                   "shape": list(v.shape), "data": v.numpy().tobytes()}
               for k, v in ckpt_flatten(state_to_jax(ts))}
    assert msgpack.packb(payload) == tb
    jm_, tm_ = (json.loads((d / "step_00000003" / "manifest.json")
                           .read_text()) for d in (jdir, tdir))
    assert tm_ == jm_


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "xlstm-350m",
                                  "zamba2-7b"])
def test_checkpoint_port_to_reference(arch, tmp_path):
    """A checkpoint the port wrote (after a step) restores in the
    reference with equal values."""
    jm, js = _ref_state(arch)
    tm, ts = _port_state_from(arch, js)
    ts, _ = make_train_step(tm, peak_lr=1e-3, warmup=1)(ts, _batch(arch, 2, 16))
    save_checkpoint(str(tmp_path), 1, ts)
    restored, step = j_ckpt.restore_checkpoint(str(tmp_path), js)
    assert step == 1
    want = dict(_flatten(state_to_jax(ts)))
    got = dict(_flatten(jax.tree.map(np.asarray, restored)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k].numpy(), err_msg=k)
    assert int(got["step"]) == 1


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "musicgen-large",
                                  "zamba2-7b"])
def test_checkpoint_reference_to_port(arch, tmp_path):
    """A checkpoint the reference wrote restores into a port state (drawn
    from other weights) with equal values."""
    jm, js = _ref_state(arch)
    j_ckpt.save_checkpoint(str(tmp_path), 2, js)
    tm = build_model(SMOKES[arch])
    ts = init_train_state(tm, torch.Generator().manual_seed(9), device="cpu")
    restored, step = restore_checkpoint(str(tmp_path), ts)
    assert step == 2 and restored is ts
    want = dict(_flatten(jax.tree.map(np.asarray, js)))
    got = {k: v.numpy() for k, v in _flatten(state_to_jax(ts)).items()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert all(p.requires_grad for p in ts["params"].parameters())


def test_params_to_jax_inverts_params_from_jax():
    for arch in ("qwen2-0.5b", "xlstm-350m", "zamba2-7b"):
        jp = jax.tree.map(np.asarray, j_build_model(J_SMOKES[arch]).init(
            jax.random.PRNGKey(2)))
        back = params_to_jax(params_from_jax(SMOKES[arch], jp, device="cpu"))
        want, got = dict(_flatten(jp)), dict(_flatten(back))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k])
