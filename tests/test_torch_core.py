"""The port's copies of the reference's ``core`` and ``npu`` modules,
held against the reference on the same inputs. The copies are the same
Python, so every comparison is equality: compiled programs, discrete
simulator results, vNPU manager and KV ledger states, allocator,
fabric, fault and admission outcomes.
"""
import dataclasses
import enum
import types

import pytest

import repro.core as R
import repro.core.admission as r_adm
import repro.core.fabric as r_fab
import repro.core.vnpu as r_vnpu
import repro.npu.hw_config as r_hw
import repro.npu.trace as r_trace
import repro.npu.workloads as r_wl
import repro_torch.core as T
import repro_torch.core.admission as t_adm
import repro_torch.core.fabric as t_fab
import repro_torch.core.vnpu as t_vnpu
import repro_torch.npu.hw_config as t_hw
import repro_torch.npu.trace as t_trace
import repro_torch.npu.workloads as t_wl
from repro.configs import SMOKES as R_SMOKES
from repro_torch.configs import SMOKES as T_SMOKES

GOLDEN = {
    # tests/test_policies.py::GOLDEN: BERT+DLRM, n_requests=4, §V-A setup
    #            makespan             p95(tenant0)         p95(tenant1)
    "pmt":      (533531764.55165005, 133509284.63199885, 20028.07200000435),
    "v10":      (344284417.11341304, 86178433.86729868, 22076.07200000435),
    "neu10_nh": (498662424.576, 124665606.144, 19361.45562505722),
    "neu10":    (308027475.27508926, 77007456.66018084, 20641.455624997616),
}
PAIRS = [("RsNt", "DLRM"), ("BERT", "ENet"), ("ENet", "TFMR")]
POLICIES = ["pmt", "v10", "neu10_nh", "neu10"]
SEG = 1 << 20

# each package's modules under one set of names
REF = types.SimpleNamespace(core=R, hw=r_hw, wl=r_wl, trace=r_trace,
                            vnpu=r_vnpu, fab=r_fab, adm=r_adm,
                            smokes=R_SMOKES)
PORT = types.SimpleNamespace(core=T, hw=t_hw, wl=t_wl, trace=t_trace,
                             vnpu=t_vnpu, fab=t_fab, adm=t_adm,
                             smokes=T_SMOKES)


def plain(x, skip=()):
    """A package-free image of ``x``: dataclasses and plain objects as
    (class name, fields), enums by name, containers element by element.
    Two packages' results compare equal exactly when their values do."""
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
    if hasattr(x, "__dict__") and not isinstance(x, (type, types.ModuleType)):
        return (type(x).__name__,
                {k: plain(v, skip) for k, v in vars(x).items()
                 if k not in skip})
    return x


def both(fn):
    """fn(package namespace) for the reference and the port."""
    return fn(REF), fn(PORT)


def test_packages_export_the_same_names():
    assert T.__all__ == R.__all__
    assert T.available_policies() == R.available_policies()
    assert list(t_wl.WORKLOADS) == list(r_wl.WORKLOADS)
    assert t_wl.PAPER_PAIRS == r_wl.PAPER_PAIRS
    assert t_wl._BATCH_OVERRIDES == r_wl._BATCH_OVERRIDES
    assert plain(t_hw.DEFAULT_CORE) == plain(r_hw.DEFAULT_CORE)
    assert t_fab.DEFAULT_LINK_BW == r_fab.DEFAULT_LINK_BW


@pytest.mark.parametrize("n_eng", [4, 8], ids=["default_core", "core8x8"])
@pytest.mark.parametrize("name", list(r_wl.WORKLOADS))
def test_programs_equal(name, n_eng):
    """Trace, NeuISA program (every group's μTOps with their cycles,
    HBM bytes, snippets and control) and VLIW program, on the default
    4 ME / 4 VE core and on an 8 ME / 8 VE one."""
    def run(P):
        core = P.hw.NPUCoreConfig(n_me=n_eng, n_ve=n_eng)
        tr = P.wl.get_workload(name, core)
        prog = P.core.compile_neuisa(tr, core)
        groups = [(g.me_work, g.ve_work, len(g.me_utops),
                   sum(u.hbm_bytes for u in g.all_utops()))
                  for g in prog.groups]
        return (plain(tr), plain(prog), groups,
                plain(P.core.compile_vliw(tr, core)))
    ref, port = both(run)
    assert port == ref


def test_request_plans_equal():
    """An assigned architecture as a tenant (``assigned_arch_tenant``,
    prefill and decode) and its compiled, chunked request plan."""
    def run(P):
        cfg = P.smokes["qwen2-0.5b"]
        tenants = [P.wl.assigned_arch_tenant(cfg, phase)
                   for phase in ("prefill", "decode")]
        plan = P.trace.request_plan(cfg, batch=1, prompt_len=600,
                                    gen_len=4, prefill_chunk_tokens=256)
        cplan = P.core.compile_request_plan(plan, P.hw.DEFAULT_CORE,
                                            isa="neuisa")
        return plain(tenants), plain(plan), plain(cplan, skip={"cache"})
    ref, port = both(run)
    assert port == ref


def _run_pair(P, w1, w2, policy, n_requests=4):
    """``benchmarks/common.py::run_pair``'s §V-A setup from the core
    modules alone: two 2 ME / 2 VE vNPUs with half the memory each."""
    core = P.hw.DEFAULT_CORE
    policy_cls = type(P.core.resolve_policy(policy))
    mapping = "spatial" if policy_cls.spatial else "temporal"
    mgr = P.core.VNPUManager(core=core)
    specs = []
    for name in (w1, w2):
        cfg = P.core.VNPUConfig(2, 2, hbm_bytes=core.hbm_bytes // 2,
                                sram_bytes=core.sram_bytes // 2)
        v = mgr.create(cfg, name=name, mapping=mapping)
        prog = policy_cls.compile_program(P.wl.get_workload(name, core),
                                          core)
        specs.append(P.core.TenantSpec(prog, v, n_requests,
                                       weight=cfg.priority))
    return P.core.Simulator(specs, policy=policy_cls, core=core).run()


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("pair", PAIRS, ids="+".join)
def test_discrete_simulator_equal(pair, policy):
    """SimResult bit for bit: makespan, every tenant's latency series,
    ME/VE work and the rest of the stats."""
    ref, port = both(lambda P: _run_pair(P, *pair, policy))
    assert port.makespan == ref.makespan
    for a, b in zip(port.tenants, ref.tenants):
        assert a.latencies == b.latencies
        assert (a.me_work, a.ve_work) == (b.me_work, b.ve_work)
    assert plain(port) == plain(ref)


@pytest.mark.parametrize("policy", POLICIES)
def test_port_meets_policy_goldens(policy):
    """The reference's BERT+DLRM goldens, by relative tolerance (never
    by equality after rounding: see the evict goldens' last digit)."""
    makespan, p95_a, p95_b = GOLDEN[policy]
    res = _run_pair(PORT, "BERT", "DLRM", policy)
    assert res.makespan == pytest.approx(makespan, rel=1e-9)
    assert res.tenants[0].p95() == pytest.approx(p95_a, rel=1e-9)
    assert res.tenants[1].p95() == pytest.approx(p95_b, rel=1e-9)


def test_vnpu_manager_equal():
    """create / reconfigure / destroy on a two-core manager, then a
    failed core: every core's free lists, residents (by name) and each
    vNPU's mapping."""
    def run(P):
        mgr = P.core.VNPUManager(n_pnpus=2, core=P.hw.DEFAULT_CORE)
        cfg = P.core.VNPUConfig
        a = mgr.create(cfg(2, 2, hbm_bytes=4 << 30), name="a")
        b = mgr.create(cfg(1, 3, hbm_bytes=2 << 30), name="b")
        c = mgr.create(cfg(3, 1, hbm_bytes=8 << 30), name="c",
                       mapping="temporal")
        a = mgr.reconfigure(a, cfg(3, 2, hbm_bytes=6 << 30))
        mgr.destroy(b)
        d = mgr.create(cfg(1, 1, hbm_bytes=1 << 30), name="d", core_hint=1)
        names = {v.vnpu_id: v.name for v in mgr.vnpus.values()}
        evacuated = [names[i] for i in mgr.fail_core(mgr.core_index_of(a))]
        cores = [(plain(cs, skip={"residents"}),
                  [names[i] for i in cs.residents]) for cs in mgr.cores]
        vnpus = [plain(v, skip={"vnpu_id"}) for v in (a, b, c, d)]
        return cores, vnpus, evacuated, mgr.hbm_census()
    ref, port = both(run)
    assert port == ref


def test_kv_ledger_equal():
    """alloc / free / shared-prefix acquire and release / cross-ledger
    migrate / reject and capacity moves: equal ledgers throughout."""
    def run(P):
        L = P.vnpu.KVLedger
        leds = [L(8 * SEG, SEG, reserved_bytes=SEG), L(4 * SEG, SEG),
                L(6 * SEG, SEG)]
        out = [leds[0].alloc(1, 2.5 * SEG), leds[0].alloc(2, 3 * SEG),
               leds[0].alloc(3, 4 * SEG), leds[1].alloc(7, SEG),
               leds[0].acquire_shared(11, 0.5 * SEG),
               leds[1].acquire_shared(11, 0.5 * SEG),
               leds[0].acquire_shared(11, 0.5 * SEG),
               leds[0].migrate_entry_to(leds[1], 2),
               leds[0].migrate_entry_to(leds[2], 2),
               leds[0].migrate_entry_to(leds[1], 1, dst_rid=9),
               leds[2].free(2), leds[0].release_shared(11),
               leds[0].release_shared(11), leds[1].lend(SEG)]
        with pytest.raises(P.vnpu.KVLedgerError):
            leds[0].free(2)
        leds[2].migrate_from(leds[1])
        return out, [plain(led) for led in leds]
    ref, port = both(run)
    assert port == ref


def test_f4_zero_byte_migration_onto_a_live_rid_raises():
    """Reference behaviour, kept for parity: rid 0 allocated with 0
    bytes on ledgers 0 and 2, then migrated from 0 to 2, raises
    ``KVLedgerError`` ("target rid 0 already live"), since the
    destination already holds a (zero-byte) entry under that rid. This
    is the counterexample behind the rare failure of
    ``test_fabric.py::test_cross_ledger_migration_conserves_segments``,
    whose mirror model expects the migration to succeed."""
    for P in (REF, PORT):
        leds = [P.vnpu.KVLedger(c * SEG, SEG) for c in (1, 1, 1)]
        assert leds[0].alloc(0, 0) and leds[2].alloc(0, 0)
        with pytest.raises(P.vnpu.KVLedgerError, match="already live"):
            leds[0].migrate_entry_to(leds[2], 0)
        assert leds[0].entries == {0: 0} and leds[2].entries == {0: 0}


def test_allocator_equal():
    """Eq. 1-4 splits of three workloads at several budgets, the
    credit-weighted fill, and placement on a 2-D mesh fabric."""
    def run(P):
        core = P.hw.DEFAULT_CORE
        out = []
        for name in ("BERT", "DLRM", "ENet"):
            tr = P.wl.get_workload(name, core)
            m, v = tr.profile_mv()
            out.append((P.core.optimal_ratio(m, v),
                        [plain(P.core.allocate_eus(m, v, eus, core))
                         for eus in (2, 3, 5, 8)],
                        plain(P.core.allocate_for_trace(tr, 6, core))))
        out.append(P.core.allocator.credit_weighted_fill(
            [("a", 2.0, 4, 2), ("b", 0.5, 2, 1), ("c", 3.0, 6, 8),
             ("d", 1.0, 2, 0)], 8, 6, 16, 12))
        topo = P.core.FabricTopology.mesh(9)
        topo.degrade_link(0, 1, 0.25)
        loads = [0.1 * i for i in range(9)]
        out.append((P.core.place_phase_pair(topo, loads, kv_bytes=1e8),
                    P.core.place_phase_pair(topo, kv_bytes=1e6,
                                            distinct=False),
                    P.core.pick_evacuation_core(topo, 4, [0, 1, 2, 5, 8],
                                                loads, kv_bytes=1e9)))
        return out
    ref, port = both(run)
    assert port == ref


def test_fabric_and_faults_equal():
    """Seeded random placements and a seeded chaos schedule."""
    def run(P):
        topo = P.core.FabricTopology.ring(6)
        links = [(i, (i + 1) % 6) for i in range(6)]
        sched = P.core.FaultSchedule.chaos(
            horizon=1e9, n_cores=6, links=links, seed=7,
            core_fault_rate=3.0, link_fault_rate=2.0, hbm_fault_rate=1.0,
            transient_frac=0.5, recovery=1e7, link_outage_frac=0.5)
        return ([P.core.random_phase_pair(topo, seed) for seed in range(8)],
                [topo.transfer_cycles(0, d, 1e8) for d in range(6)],
                plain(list(sched)))
    ref, port = both(run)
    assert port == ref
    assert len(ref[2]) > 0


def test_admission_equal():
    """One AdmissionController over a fixed sequence of asks, SLO
    observations and scale-ups: decisions, balances, ranks."""
    def run(P):
        A, F = P.adm.AdmissionAsk, P.adm.FleetState
        ctl = P.adm.AdmissionController(initial_credit=1.0)
        asks = [A("a", 8, 4, slo_ttft_ms=50.0), A("b", 6, 2),
                A("c", 12, 8, slo_tbt_ms=20.0, slo_p95_ms=200.0),
                A("d", 4, 0, min_eus=4)]
        out = []
        free = 16
        for i, ask in enumerate(asks * 2):
            fleet = F(free, 32, 24 - i, 32)
            d = ctl.decide(ask, 0.25 * i, fleet)
            free = max(free - d.eus, 2)
            out.append(plain(d))
            ctl.observe(ask.name, 0.25 * i + 0.1, i % 3)
        out.append(ctl.approve_scaleup("a", 4, 3.0, F(4, 32, 4, 32)))
        out.append(ctl.rank(asks, 3.5, F(10, 32, 10, 32)))
        out.append([(n, ctl.balance(n, 4.0)) for n in "abcd"])
        return out, plain(ctl.accounts)
    ref, port = both(run)
    assert port == ref
