"""The port's serving path against the reference's, on the CPU: the
dense smoke config from the reference's init, converted. Prefill and
decode logits agree to 1e-5 and greedy tokens are identical. Also decode
against prefill for every smoke config, and the package boundary: the
port loads neither JAX nor the reference package.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as J_SMOKES
from repro.models.registry import build_model as j_build_model
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import build_model, resolve_device
from repro_torch.configs import SMOKES
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServeEngine

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "qwen2-0.5b"


@pytest.fixture(scope="module")
def engines():
    """The reference engine and the port's, on the same weights."""
    j = JServeEngine(J_SMOKES[ARCH], max_seq=64)
    p = params_from_jax(SMOKES[ARCH], jax.tree.map(np.asarray, j.params),
                        device="cpu")
    return j, ServeEngine(SMOKES[ARCH], params=p, max_seq=64, device="cpu")


def _prompt(seed, B=2, S=16):
    return np.random.default_rng(seed).integers(
        0, SMOKES[ARCH].vocab_size, (B, S)).astype(np.int32)


def test_prefill_and_decode_logits_match(engines):
    j, t = engines
    prompt = _prompt(0, S=20)
    j_cache = j.model.init_cache(2, 64)
    j_logits, j_cache = j.model.prefill(j.params, {"tokens": prompt}, j_cache)
    t_cache = t.model.init_cache(2, 64, device="cpu")
    t_logits, t_cache = t.model.prefill(
        t.params, {"tokens": torch.from_numpy(prompt).long()}, t_cache)
    assert t_logits.shape == (2, 20, SMOKES[ARCH].vocab_size)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)
    for a, b in zip(t_cache, j_cache):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    nxt = np.asarray(jnp.argmax(j_logits[:, -1:], -1), np.int32)
    for i in range(4):
        j_logits, j_cache = j.model.decode_step(
            j.params, j_cache, {"tokens": nxt, "cache_index": 20 + i})
        t_logits, t_cache = t.model.decode_step(
            t.params, t_cache,
            {"tokens": torch.tensor(nxt, dtype=torch.long),
             "cache_index": 20 + i})
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   **TOL)
        nxt = np.asarray(jnp.argmax(j_logits, -1), np.int32)


@pytest.mark.parametrize("seed,B,S,n_new", [(1, 2, 16, 8), (2, 1, 33, 12),
                                             (3, 3, 5, 20)])
def test_greedy_tokens_identical(engines, seed, B, S, n_new):
    j, t = engines
    prompt = _prompt(seed, B, S)
    want = j.generate(prompt, n_new=n_new).tokens
    got = t.generate(prompt, n_new=n_new)
    assert got.tokens.shape == (B, n_new)
    np.testing.assert_array_equal(got.tokens, want)
    assert got.prefill_s > 0 and got.decode_s > 0
    assert got.tokens_per_s == pytest.approx(B * n_new / got.decode_s)


def test_decode_from_converted_cache(engines):
    """A cache filled by the reference continues in the port."""
    j, t = engines
    prompt = _prompt(4, S=10)
    j_logits, j_cache = j.model.prefill(j.params, {"tokens": prompt},
                                        j.model.init_cache(2, 64))
    nxt = np.asarray(jnp.argmax(j_logits[:, -1:], -1), np.int32)
    want, _ = j.model.decode_step(j.params, j_cache,
                                  {"tokens": nxt, "cache_index": 10})
    got, _ = t.model.decode_step(
        t.params, cache_from_jax(j_cache, "cpu"),
        {"tokens": torch.tensor(nxt, dtype=torch.long), "cache_index": 10})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_last_only_and_padded_vocab():
    """prefill_last_only keeps the last position; padded vocab slots are
    masked to -1e30, as in the reference."""
    cfg = SMOKES[ARCH].replace(vocab_size=500, pad_vocab=True,
                               tie_embeddings=False)
    jp = j_build_model(cfg).init(jax.random.PRNGKey(5))
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    prompt = _prompt(5, S=9) % 500
    jm = j_build_model(cfg, prefill_last_only=True)
    tm = build_model(cfg, prefill_last_only=True)
    want, _ = jm.prefill(jp, {"tokens": prompt}, jm.init_cache(2, 16))
    got, _ = tm.prefill(tp, {"tokens": torch.from_numpy(prompt).long()},
                        tm.init_cache(2, 16, device="cpu"))
    assert got.shape == (2, 1, 512)
    assert bool((got[..., 500:] == -1e30).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_temperature_sampling_is_seeded(engines):
    _, t = engines
    prompt = _prompt(6)
    a = t.generate(prompt, n_new=10, temperature=1.0, seed=3).tokens
    b = t.generate(prompt, n_new=10, temperature=1.0, seed=3).tokens
    c = t.generate(prompt, n_new=10, temperature=1.0, seed=4).tokens
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < SMOKES[ARCH].vocab_size


def test_init_is_seeded_and_counts_params():
    cfg = SMOKES[ARCH]
    m = build_model(cfg)
    a = m.init(torch.Generator().manual_seed(0), device="cpu")
    b = m.init(torch.Generator().manual_seed(0), device="cpu")
    c = m.init(torch.Generator().manual_seed(1), device="cpu")
    assert sum(p.numel() for p in a.parameters()) == cfg.param_count()
    for (n, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                               c.parameters()):
        assert torch.equal(pa, pb), n
        assert not pa.requires_grad
    assert not torch.equal(a.embed, c.embed)
    assert not torch.equal(a.layers[1].attn.wq, c.layers[1].attn.wq)
    assert float(a.embed.std()) == pytest.approx(0.02, rel=0.05)


def test_prompt_too_long_raises(engines):
    with pytest.raises(ValueError, match="max_seq"):
        engines[1].generate(_prompt(7, S=60), n_new=8)


def test_unknown_family_raises():
    """As the reference's Model.init: an unknown family is a ValueError."""
    cfg = SMOKES[ARCH].replace(family="rnn")
    m = build_model(cfg)
    with pytest.raises(ValueError, match="rnn"):
        m.init(torch.Generator(), device="cpu")
    with pytest.raises(ValueError, match="rnn"):
        m.init_cache(1, 8, device="cpu")
    with pytest.raises(ValueError, match="rnn"):
        T.Transformer(cfg, device="cpu")


@pytest.mark.parametrize("arch", sorted(SMOKES))
def test_decode_matches_prefill(arch):
    """The port's counterpart of the reference's test of the same name:
    the logits of a decode step after a prefill of S tokens equal the
    last logits of a prefill of S + 1 (a vlm decodes at n_patches + S,
    after the patches)."""
    cfg = SMOKES[arch]
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    B, S = 2, 16
    g = torch.Generator().manual_seed(1)
    shape = (B, cfg.n_codebooks, S + 1) if cfg.family == "audio" \
        else (B, S + 1)
    toks = torch.randint(0, cfg.vocab_size, shape, generator=g)
    batch = {"tokens": toks[..., :S]}
    n_prefix = cfg.n_patches if cfg.family == "vlm" else 0
    if n_prefix:
        batch["patch_embeds"] = torch.randn((B, n_prefix, cfg.d_model),
                                            generator=g)
    _, cache = model.prefill(params, batch,
                             model.init_cache(B, S + n_prefix + 8,
                                              device="cpu"))
    lg_dec, _ = model.decode_step(params, cache, {
        "tokens": toks[..., S:], "cache_index": S + n_prefix})
    lg_full, _ = model.prefill(params, dict(batch, tokens=toks),
                               model.init_cache(B, S + n_prefix + 8,
                                                device="cpu"))
    torch.testing.assert_close(lg_dec[:, 0], lg_full[:, -1], **TOL)


def test_entry_points_default_to_cuda():
    """With no device, entry points run on cuda: where there is no card
    they raise instead of dropping to the CPU."""
    cfg = SMOKES[ARCH]
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg).init(torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_port_imports_neither_jax_nor_reference():
    """A fresh interpreter that imports the port, serves on the CPU,
    compiles two workloads, runs the fluid simulator and the serving
    control plane, and takes a training step with a checkpoint on the
    CPU has loaded no JAX, no msgpack and nothing of the reference
    package."""
    code = textwrap.dedent("""
        import sys
        import tempfile
        import numpy as np
        import repro_torch
        import repro_torch.checkpoint
        import repro_torch.core
        import repro_torch.npu
        import repro_torch.serve.session
        import repro_torch.serve.vserve
        import repro_torch.train.loop
        from repro_torch import ServeEngine, SMOKES
        from repro_torch.core import compile_neuisa
        from repro_torch.core.sim_torch import pack_pair, simulate_pair
        from repro_torch.npu.workloads import get_workload
        from repro_torch.serve import MultiTenantServer
        from repro_torch.train import TrainConfig, train
        with tempfile.TemporaryDirectory() as d:
            out = train(SMOKES["qwen2-0.5b"],
                        TrainConfig(steps=1, batch=1, seq=8, device="cpu",
                                    ckpt_dir=d), log_fn=lambda *_: None)
            assert np.isfinite(out["final_loss"])
            assert repro_torch.checkpoint.checkpointer.list_checkpoints(d) == [1]
        srv = MultiTenantServer(policy="neu10")
        srv.register("a", get_workload("MNIST"), eu_budget=4)
        _, reports = srv.simulate(n_requests=2)
        assert reports[0].requests_done >= 2
        for arch, cfg in SMOKES.items():
            shape = (1, cfg.n_codebooks, 8) if cfg.family == "audio" else (1, 8)
            res = ServeEngine(cfg, max_seq=32, device="cpu").generate(
                np.zeros(shape, np.int32), n_new=3)
            assert res.tokens.shape == shape[:-1] + (3,)
        p1, p2 = (compile_neuisa(get_workload(n)) for n in ("MNIST", "NCF"))
        out = simulate_pair(pack_pair(p1, p2, device="cpu"), (2, 2), (2, 2),
                            2, device="cpu")
        assert float(out["makespan"]) > 0 and int(out["events"]) > 0
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro",
                                            "msgpack"))
        assert not bad, bad
        print("clean")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_port_sources_import_no_jax_or_reference():
    """No source file of the port (nor chip_smoke.py) imports them, nor
    msgpack (the port's checkpoints use their own codec)."""
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                assert mod.split(".")[0] not in ("jax", "jaxlib", "repro",
                                                 "msgpack"), \
                    f"{f.name}: {s}"


@pytest.mark.parametrize("kernel", ["flash_attention", "grouped_matmul"])
def test_kernel_launch_refuses_grad(kernel):
    """The CUDA kernels have no backward: their launchers raise when
    grad mode is on and an input requires grad, before the device
    check. Under no_grad the same call gets past the guard and fails the
    device check instead (these tensors lie on the CPU)."""
    if kernel == "flash_attention":
        from repro_torch.kernels import flash_attention as mod
        args = [torch.zeros(1, 4, 2, 64), torch.zeros(1, 4, 2, 64),
                torch.zeros(1, 4, 2, 64), True]
    else:
        from repro_torch.kernels import grouped_matmul as mod
        args = [torch.zeros(2, 4, 8), torch.zeros(2, 8, 8)]
    args[1].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        mod._launch(*args)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA device"):
        mod._launch(*args)
