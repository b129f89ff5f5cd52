"""The port's copy of the serving control plane (``serve.session``,
``serve.vserve``), held against the reference. Each scenario is written
once, as a function of a package namespace, and run in both packages;
the copies are the same Python, so their reports compare equal. The
reference's pressure goldens (``tests/test_kv_prefix.py``) are held with
a relative tolerance on the unrounded sums, never after ``round`` (their
evict case fails by equality on the last rounded digit, ROADMAP F3).
"""
import dataclasses
import enum
import math
import types

import pytest

import repro.core.admission as r_adm
import repro.core.fabric as r_fab
import repro.core.faults as r_faults
import repro.core.mapper as r_mapper
import repro.npu.cost_model as r_cost
import repro.npu.hw_config as r_hw
import repro.npu.workloads as r_wl
import repro.serve as r_serve
import repro.serve.session as r_sess
import repro.serve.vserve as r_vserve
import repro_torch.core.admission as t_adm
import repro_torch.core.fabric as t_fab
import repro_torch.core.faults as t_faults
import repro_torch.core.mapper as t_mapper
import repro_torch.npu.cost_model as t_cost
import repro_torch.npu.hw_config as t_hw
import repro_torch.npu.workloads as t_wl
import repro_torch.serve as t_serve
import repro_torch.serve.session as t_sess
import repro_torch.serve.vserve as t_vserve
from repro.configs import SMOKES as R_SMOKES
from repro_torch.configs import SMOKES as T_SMOKES

REF = types.SimpleNamespace(sess=r_sess, vserve=r_vserve, adm=r_adm,
                            fab=r_fab, faults=r_faults, mapper=r_mapper,
                            cost=r_cost, hw=r_hw, wl=r_wl, smokes=R_SMOKES)
PORT = types.SimpleNamespace(sess=t_sess, vserve=t_vserve, adm=t_adm,
                             fab=t_fab, faults=t_faults, mapper=t_mapper,
                             cost=t_cost, hw=t_hw, wl=t_wl, smokes=T_SMOKES)

SEG = 64 * 1024
# tests/test_kv_prefix.py::PREFIX_OFF_GOLDEN, pressure cases: requests,
# tokens, evictions, swap-ins, restarts, rejected, truncated, then
# sum(latencies), sum(ttft), sum(tbt) and the final clock, as that file
# captured them (rounded to 1e-6 cycles there; compared here at REL).
PRESSURE_GOLDEN = {
    "evict": [24, 2132, 30, 30, 0, 0, 0,
              12212025.457979, 4016983.948854,
              8195041.509125, 1624303.296264],
    "reject": [24, 3088, 42, 0, 42, 0, 0,
               17339038.22723, 9544632.355104,
               6852367.88375, 2498489.253263],
}
FABRIC_GOLDEN = [[0, 20, 20, 655360.0, 0, 62566.72, 0],
                 [20, 140, 0, 0.0, 406532.357501, 0, 343965.637501],
                 103331327.755612]
# The goldens keep 6 decimals. Half a unit of the 6th decimal is at
# most 8e-12 of the smallest non-zero float in them (62566.72), so REL
# is the rounding the goldens carry, not a slack on the simulator.
REL = 1e-11


def plain(x, skip=()):
    """A package-free image of ``x``: dataclasses and plain objects as
    (class name, fields), enums by name, containers element by element."""
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: plain(getattr(x, f.name), skip)
                 for f in dataclasses.fields(x) if f.name not in skip})
    if isinstance(x, (list, tuple)):
        return [plain(v, skip) for v in x]
    if isinstance(x, dict):
        return {plain(k, skip): plain(v, skip) for k, v in x.items()}
    return x


def both(fn):
    """fn(package namespace) for the reference and the port."""
    return fn(REF), fn(PORT)


def _trace(P, name="w", me=200_000.0, ve=50_000.0, n_ops=8):
    return P.cost.WorkloadTrace(name, [
        P.cost.Operator(f"{name}_mm{i}", me_cycles=me / n_ops,
                        ve_cycles=ve / n_ops, n_tiles=8)
        for i in range(n_ops)], core=P.hw.DEFAULT_CORE)


def _session(P, policy="neu10", **kw):
    return P.sess.ServingSession(P.sess.NPUCluster(policy=policy), **kw)


def _small_core(P, segs=1024):
    return P.hw.DEFAULT_CORE.with_(hbm_bytes=segs * SEG, hbm_segment=SEG)


def _wseg(P):
    weights = P.smokes["qwen2-0.5b"].param_count() * 2
    return -(-weights // SEG) * SEG


def _stats(sess, h):
    return plain(sess.sims[h.core_idx].tenants[h.sim_idx].stats)


# ----------------------------------------------------------------------
def test_serve_packages_export_the_same_names():
    assert set(r_serve.__all__) <= set(t_serve.__all__)
    assert set(t_serve.__all__) - set(r_serve.__all__) == {
        "GenerationResult"}
    for name in r_serve.__all__:
        if name != "ServeEngine":   # the port's engine is its own
            assert getattr(t_serve, name).__name__ == getattr(
                r_serve, name).__name__
    assert t_vserve.__all__ == r_vserve.__all__


# ----------------------------------------------------------------------
# tests/test_session.py
# ----------------------------------------------------------------------
def test_open_loop_poisson_equal():
    def run(P):
        sess = _session(P)
        h = sess.register("a", _trace(P), eu_budget=4)
        n = sess.submit_arrivals(h, P.sess.PoissonArrivals(
            rate_rps=2000.0, n=40, seed=7))
        sess.drain()
        return n, plain(sess.report(h)), sess.latencies_ms(h)
    ref, port = both(run)
    assert port == ref
    assert port[1][0][1]["requests_done"] == 40


def test_open_loop_deterministic_and_equal():
    def run(P):
        sess = _session(P)
        h = sess.register("a", _trace(P), eu_budget=4)
        sess.submit_arrivals(h, P.sess.PoissonArrivals(
            rate_rps=1000.0, n=25, seed=3))
        sess.submit_arrivals(h, P.sess.TraceArrivals([0.03, 0.031]))
        sess.submit(h, at_s=0.04)
        sess.drain()
        return sess.latencies_ms(h)
    ref, port = both(run)
    assert port == ref == run(PORT)
    assert len(port) == 28


def test_midrun_register_resize_deregister_equal():
    def run(P):
        sess = _session(P)
        a = sess.register("a", _trace(P, "a"), eu_budget=2)
        sess.submit_arrivals(a, P.sess.PoissonArrivals(
            rate_rps=1000.0, n=50, seed=1))
        sess.run_until(0.01)
        t_pause = sess.sim.now
        b = sess.register("b", _trace(P, "b", me=50_000.0), eu_budget=2)
        sess.submit_arrivals(b, P.sess.PoissonArrivals(
            rate_rps=2000.0, n=40, seed=2, start_s=sess.now_s))
        sess.run_until(0.02)
        sess.resize(a, 4)
        sess.run_until(0.03)
        rb = plain(sess.report(b))
        sess.deregister(b)
        sess.drain()
        c = sess.register("c", _trace(P, "c"), eu_budget=2)
        sess.submit(c)
        sess.drain()
        return (t_pause, a.vnpu.config.n_eus, rb, plain(sess.report()),
                sess.latencies_ms(a))
    ref, port = both(run)
    assert port == ref
    assert [r[1]["requests_done"] for r in port[3]] == [50, 1]


def test_resize_failure_restores_in_both():
    def run(P):
        sess = _session(P)
        a = sess.register("a", _trace(P, "a"), eu_budget=4)
        sess.register("b", _trace(P, "b"), eu_budget=4)
        sess.submit_arrivals(a, P.sess.PoissonArrivals(
            rate_rps=1000.0, n=10, seed=5))
        sess.run_until(0.002)
        with pytest.raises(P.mapper.ReconfigureError):
            sess.resize(a, 8)
        sess.drain()
        return a.vnpu.config.n_eus, plain(sess.report(a))
    ref, port = both(run)
    assert port == ref


def test_slo_autoscaler_equal():
    def run(P):
        sess = _session(P, autoscaler=P.sess.SLOAutoscaler(
            step_eus=2, max_eus=8, min_samples=3))
        a = sess.register("a", _trace(P, "a", me=2_000_000.0),
                          eu_budget=2, slo_p95_ms=0.5)
        sess.submit_arrivals(a, P.sess.PoissonArrivals(
            rate_rps=2000.0, n=60, seed=6))
        budgets = []
        for i in range(6):
            sess.run_until(0.01 * (i + 1))
            budgets.append(a.eu_budget)
        sess.drain()
        return budgets, plain(sess.report(a))
    ref, port = both(run)
    assert port == ref
    assert port[0][-1] > 2


def test_multi_core_session_equal():
    def run(P):
        sess = P.sess.ServingSession(P.sess.NPUCluster(n_pnpus=2))
        a = sess.register("a", _trace(P, "a"), eu_budget=4)
        b = sess.register("b", _trace(P, "b"), eu_budget=6)
        sess.submit(a, at_s=0.001)
        sess.submit_arrivals(b, P.sess.PoissonArrivals(
            rate_rps=3000.0, n=12, seed=2))
        sess.drain()
        return len(sess.sims), a.core_idx, b.core_idx, plain(sess.report())
    ref, port = both(run)
    assert port == ref


def test_closed_loop_and_server_shim_equal():
    def run(P):
        cluster = P.sess.NPUCluster(policy="neu10")
        cluster.register("a", _trace(P, "a"), eu_budget=4)
        cluster.register("b", _trace(P, "b", me=400_000.0), eu_budget=4)
        res, reports = P.sess.run_closed_loop(cluster, n_requests=3)
        srv = P.vserve.MultiTenantServer(policy="neu10")
        srv.register("a", _trace(P, "a"), eu_budget=4)
        srv.register("b", _trace(P, "b", me=400_000.0), eu_budget=4)
        res2, reports2 = srv.simulate(n_requests=3)
        return plain(res), plain(reports), plain(res2), plain(reports2)
    ref, port = both(run)
    assert port == ref
    assert port[0] == port[2]


# ----------------------------------------------------------------------
# tests/test_serve.py (MultiTenantServer) and test_system.py
# ----------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["pmt", "v10", "neu10_nh", "neu10"])
def test_multitenant_server_equal(policy):
    def run(P):
        srv = P.vserve.MultiTenantServer(policy=policy)
        a = srv.register("rsnt", P.wl.get_workload("RsNt"), eu_budget=4)
        b = srv.register("dlrm", P.wl.get_workload("DLRM"), eu_budget=4)
        res, reports = srv.simulate(n_requests=4)
        return (plain(a.allocation), plain(b.allocation),
                res.total_throughput(), res.me_utilization(),
                plain(reports))
    ref, port = both(run)
    assert port == ref


def test_server_autoscale_and_deregister_equal():
    def run(P):
        srv = P.vserve.MultiTenantServer(policy="neu10_nh")
        t = srv.register("enet", P.wl.get_workload("ENet"), eu_budget=2)
        _, reports = srv.simulate(n_requests=3)
        t.slo_p95_ms = reports[0].p95_ms * 0.7
        scaled = srv.autoscale_to_slo(n_requests=3, max_eus=8)
        srv.deregister(t)
        b = srv.register("b", P.wl.get_workload("MNIST"), eu_budget=8)
        return (plain(reports), t.eu_budget, plain(scaled),
                b.vnpu.config.n_eus)
    ref, port = both(run)
    assert port == ref
    assert port[1] > 2


def test_control_plane_e2e_equal():
    def run(P):
        srv = P.vserve.MultiTenantServer(policy="neu10")
        srv.register("llm", P.wl.get_workload("LLaMA"), eu_budget=4)
        srv.register("bert", P.wl.get_workload("BERT"), eu_budget=4)
        res, reports = srv.simulate(n_requests=3)
        return res.makespan, plain(reports)
    ref, port = both(run)
    assert port == ref
    assert all(math.isfinite(r[1]["p95_ms"]) and r[1]["p95_ms"] > 0
               for r in port[1])


# ----------------------------------------------------------------------
# one scenario of each scheduling feature
# ----------------------------------------------------------------------
def _pressure(P, kv_policy, engine="inc", kv_segs=2, **reg_kw):
    """tests/test_kv_prefix.py::_pressure_stats, unrounded."""
    cfg = P.smokes["qwen2-0.5b"]
    sess = P.sess.ServingSession(
        P.sess.NPUCluster(core=_small_core(P), policy="neu10"),
        incremental=(engine != "full"))
    if engine == "ref":
        for s in sess.sims:
            s.fast_path = False
    chat = sess.register_generative(
        "chat", cfg, prompt_len=128,
        gen_lens=P.sess.GenLenDistribution(mean=96.0, max_len=256, seed=11),
        eu_budget=4, kv_policy=kv_policy,
        hbm_bytes=_wseg(P) + kv_segs * SEG, **reg_kw)
    sess.submit_arrivals(chat, P.sess.PoissonArrivals(
        rate_rps=200_000.0, n=24, seed=1))
    sess.drain()
    return sess, chat


@pytest.mark.parametrize("engine", ["inc", "full", "ref"])
@pytest.mark.parametrize("kv_policy", ["evict", "reject"])
def test_pressure_goldens_equal_and_within_rel(kv_policy, engine):
    def run(P):
        sess, chat = _pressure(P, kv_policy, engine)
        st = sess.sim.tenants[chat.sim_idx].stats
        return [st.requests_done, st.tokens, st.kv_evictions,
                st.kv_swapins, st.kv_restarts, st.kv_rejected,
                st.kv_truncated, sum(st.latencies), sum(st.ttft),
                sum(st.tbt), sess.sim.now]
    ref, port = both(run)
    assert port == ref
    gold = PRESSURE_GOLDEN[kv_policy]
    assert port[:7] == gold[:7]
    assert port[7:] == pytest.approx(gold[7:], rel=REL)


@pytest.mark.parametrize("engine", ["inc", "full", "ref"])
def test_fabric_golden_equal_and_within_rel(engine):
    """A ``FabricTenant``: prefill on one core, decode on a neighbour,
    every request's KV migrated over the fabric."""
    def run(P):
        sess = P.sess.ServingSession(
            P.sess.NPUCluster(core=_small_core(P), policy="neu10",
                              topology=P.fab.FabricTopology.mesh(4)),
            incremental=(engine != "full"))
        if engine == "ref":
            for s in sess.sims:
                s.fast_path = False
        ft = sess.register_generative(
            "chat", P.smokes["qwen2-0.5b"], prompt_len=128, gen_lens=8,
            eu_budget=4, placement=P.fab.Placement(), kv_policy="evict",
            hbm_bytes=256 * SEG)
        sess.submit_arrivals(ft, P.sess.PoissonArrivals(
            rate_rps=200.0, n=20, seed=1))
        sess.drain()
        out = []
        for h in (ft.prefill, ft.decode):
            st = sess.sims[h.core_idx].tenants[h.sim_idx].stats
            out.append([st.requests_done, st.tokens, st.kv_migrations,
                        st.kv_migrated_bytes, sum(st.latencies),
                        sum(st.ttft), sum(st.tbt)])
        out.append(max(s.now for s in sess.sims))
        return (type(ft).__name__, ft.hops, out, plain(sess.report(ft)),
                ft.prefill.vnpu.kv_ledger.in_use,
                ft.decode.vnpu.kv_ledger.in_use)
    ref, port = both(run)
    assert port == ref
    assert port[0] == "FabricTenant" and port[4:] == (0, 0)
    out = port[2]
    for got, gold in zip(out[:2], FABRIC_GOLDEN[:2]):
        assert got == pytest.approx(gold, rel=REL)
    assert out[2] == pytest.approx(FABRIC_GOLDEN[2], rel=REL)


def test_kv_pressure_evict_swap_roundtrip_equal():
    """tests/test_kv_pressure.py: evictions swap out and back in, no
    request lost, the ledger drains."""
    def run(P):
        sess, chat = _pressure(P, "evict")
        led = chat.vnpu.kv_ledger
        return (_stats(sess, chat), plain(sess.report(chat)),
                led.in_use, led.reserved)
    ref, port = both(run)
    assert port == ref
    st = port[0][1]
    assert st["kv_evictions"] >= 1 and st["kv_swapins"] >= 1
    assert st["requests_done"] == 24 and port[2] == 0


def test_kv_prefix_sharing_equal():
    """tests/test_kv_prefix.py: shared prompt prefixes under pressure."""
    def run(P):
        prof = P.sess.PrefixProfile(prefix_len=64, share_ratio=1.0,
                                    n_prefixes=1, seed=3)
        sess, chat = _pressure(P, "evict", kv_segs=4, prefix_profile=prof)
        return _stats(sess, chat), plain(sess.report(chat))
    ref, port = both(run)
    assert port == ref
    assert port[0][1]["kv_prefix_hits"] > 0


def test_piggyback_iterations_equal():
    """tests/test_piggyback.py: one iteration carries a prefill slice
    and live decode tokens."""
    def run(P):
        sess = _session(P)
        h = sess.register_generative(
            "g", P.smokes["qwen2-0.5b"], prompt_len=1024, gen_lens=16,
            eu_budget=4, iteration_token_budget=288)
        for at in (0.0, 0.00002, 0.00003):
            sess.submit(h, at_s=at)
        sess.drain()
        return _stats(sess, h)
    ref, port = both(run)
    assert port == ref
    st = port[1]
    assert st["requests_done"] == 3 and st["piggyback_iterations"] >= 1


def test_chunked_prefill_interleaves_equal():
    """tests/test_chunked_prefill.py: a decode runs between two prefill
    chunks of the same tenant."""
    def run(P):
        sess = _session(P)
        h = sess.register_generative(
            "g", P.smokes["qwen2-0.5b"], prompt_len=1024, gen_lens=16,
            eu_budget=4, prefill_chunk_tokens=256)
        sess.submit(h, at_s=0.0)
        sess.submit(h, at_s=0.00002)
        sess.drain()
        return _stats(sess, h)
    ref, port = both(run)
    assert port == ref
    assert port[1]["chunk_interleaved_decodes"] >= 1


def test_request_lifecycle_continuous_batching_equal():
    """tests/test_request_lifecycle.py: simultaneous arrivals share
    decode iterations."""
    def run(P):
        sess = _session(P)
        h = sess.register_generative(
            "g", P.smokes["qwen2-0.5b"], prompt_len=128, gen_lens=12,
            eu_budget=4)
        for _ in range(3):
            sess.submit(h, at_s=0.0)
        sess.drain()
        return _stats(sess, h), plain(sess.report(h))
    ref, port = both(run)
    assert port == ref
    assert port[0][1]["max_decode_batch"] >= 2


def test_admission_with_faults_and_kv_pressure_equal():
    """tests/test_admission.py: the credit gate on a two-core fabric
    under a transient core fault, with KV-evicting tenants."""
    def run(P):
        cfg = P.smokes["qwen2-0.5b"]
        core = _small_core(P, segs=64)
        link = P.fab.FabricLink(bandwidth=16.0, latency=400_000.0)
        sch = P.faults.FaultSchedule([P.faults.FaultEvent(
            at=0.0002, kind="core_down", core=1, recovery=0.002)])
        ctl = P.adm.AdmissionController(initial_credit=0.3, free_level=0.2,
                                        base_rate=1.0)
        sess = P.sess.ServingSession(
            P.sess.NPUCluster(core=core, policy="neu10",
                              topology=P.fab.FabricTopology.mesh(2, link)),
            admission=ctl, faults=sch, failover="evacuate")
        chat = sess.register_generative(
            "chat", cfg, prompt_len=128,
            gen_lens=P.sess.GenLenDistribution(mean=32.0, max_len=64, seed=7),
            eu_budget=6, kv_policy="evict", hbm_bytes=_wseg(P) + 4 * SEG,
            slo_ttft_ms=2.0, slo_tbt_ms=1.0)
        sess.submit_arrivals(chat, P.sess.PoissonArrivals(
            rate_rps=20_000.0, n=24, seed=1))
        late = sess.register_generative(
            "late", cfg, prompt_len=128, gen_lens=8, eu_budget=10,
            min_eus=2, kv_policy="evict", hbm_bytes=_wseg(P) + 2 * SEG)
        deferred = isinstance(late, P.sess.AdmissionTicket)
        sess.submit_arrivals(late, P.sess.PoissonArrivals(
            rate_rps=5000.0, n=8, seed=2))
        w = 0
        while deferred and not late.admitted and w < 600:
            w += 1
            sess.run_until(w * 0.01)
        sess.drain()
        return (deferred, w, plain(sess.report()),
                sess.cluster.manager.hbm_census(),
                all(a.conserved() for a in ctl.accounts.values()))
    ref, port = both(run)
    assert port == ref
    done = {r[1]["name"]: r[1]["requests_done"] for r in port[2]}
    assert done == {"chat": 24, "late": 8} and port[4]


@pytest.mark.parametrize("failover", ["evacuate", "restart"])
def test_fault_failover_equal(failover):
    """tests/test_faults.py: a transient core fault, survived by
    evacuation or by restart with retries."""
    def run(P):
        link = P.fab.FabricLink(bandwidth=16.0, latency=400_000.0)
        sch = P.faults.FaultSchedule([P.faults.FaultEvent(
            at=0.0002, kind="core_down", core=0, recovery=0.002)])
        sess = P.sess.ServingSession(
            P.sess.NPUCluster(core=_small_core(P), policy="neu10",
                              topology=P.fab.FabricTopology.mesh(4, link)),
            faults=sch, failover=failover)
        chat = sess.register_generative(
            "chat", P.smokes["qwen2-0.5b"], prompt_len=256, gen_lens=32,
            eu_budget=4, kv_policy="evict", hbm_bytes=256 * SEG,
            deadline_ms=50.0, max_retries=3, retry_backoff_ms=0.05)
        sess.submit_arrivals(chat, P.sess.PoissonArrivals(
            rate_rps=100_000.0, n=24, seed=1))
        sess.drain()
        return chat.core_idx, plain(sess.report(chat))
    ref, port = both(run)
    assert port == ref
    assert port[1][0][1]["requests_done"] == 24


def test_incremental_engine_equal_under_kv_pressure():
    """tests/test_incremental.py: the incremental core and the full
    rebuild give the same result under KV pressure, in both packages."""
    def run(P):
        return [plain(_pressure(P, "evict", engine)[0].sims[0].result())
                for engine in ("inc", "full")]
    ref, port = both(run)
    assert port == ref
    assert port[0] == port[1]
