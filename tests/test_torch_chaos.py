"""The port's chaos harness (``tpukube_torch/chaos``) and its scenarios 8,
9 and 13 held against the reference's.

Twins (``run_twin``, both packages, decision by decision): test_chaos.py's
tests but its two degraded-mode tests, which tests/test_torch_cli.py
already twins. The port's own: the same seed draws the same faults and
crash seams on both packages, and scenarios 8, 9 and 13 give the
reference's results on the fields the reference's tests assert."""

import random
import time

import pytest

import test_chaos
from tpukube.chaos import ChaosSpec as RefChaosSpec
from tpukube.chaos import CrashSchedule as RefCrashSchedule
from tpukube.chaos import FaultSchedule as RefFaultSchedule
from tpukube.sim import scenarios as ref_scenarios
from tpukube_torch.chaos import ChaosSpec, CrashSchedule, FaultSchedule
from tpukube_torch.sim import scenarios
from torch_refnative import use_private_tpuinfo
from torch_twin import TMP_PATH, reference_tests, run_twin

use_private_tpuinfo()

CHAOS_SKIPS = {
    "test_degraded_mode_fails_filter_and_bind_safe":
        "twinned in tests/test_torch_cli.py",
    "test_degraded_gauge_and_retry_series_render":
        "twinned in tests/test_torch_cli.py",
}
FIXTURES = {**TMP_PATH,
            "monkeypatch": lambda g: pytest.MonkeyPatch.context()}


@pytest.mark.parametrize("fn", reference_tests(test_chaos, CHAOS_SKIPS),
                         ids=lambda f: f.__name__)
def test_reference_chaos_tests_hold_on_the_port(fn):
    run_twin(fn, FIXTURES)


def test_same_seed_draws_the_same_faults_and_seams():
    spec = ChaosSpec(error_rate=0.1, timeout_rate=0.1, torn_rate=0.1,
                     slow_rate=0.1, gone_rate=0.2, drop_event_rate=0.1,
                     dup_event_rate=0.1)
    ref_spec = RefChaosSpec(**vars(spec))
    ops = random.Random(3)
    calls = [(ops.randrange(3), ops.random() < 0.5) for _ in range(400)]

    def draws(schedule_cls, s):
        sched = schedule_cls(1337, s, budget=150)
        out = []
        for kind, mutating in calls:
            if kind == 0:
                out.append(sched.draw_unary("op", mutating))
            elif kind == 1:
                out.append(sched.draw_watch_gone("watch"))
            else:
                out.append(sched.event_fate("watch"))
        return out, sched.report()

    assert draws(FaultSchedule, spec) == draws(RefFaultSchedule, ref_spec)
    port, ref = CrashSchedule(1344), RefCrashSchedule(1344)
    assert ([port.next_seam() for _ in range(20)]
            == [ref.next_seam() for _ in range(20)])


# the fields each scenario's result must share with the reference's: the
# ones the reference's own tests assert. The rest (pods placed, faults
# injected over a whole storm, WAL appends) hang on wall-clock timing, the
# circuit's reset window and what the journal's drain thread landed
# before a crash, in either package
SAME = {
    8: ("faults", "preemptions", "gang_committed", "blackout_refused",
        "evictions_pending", "leaked_reservations", "ledger_divergence"),
    9: ("restored", "partial_gang_restored", "gang_committed",
        "leaked_reservations", "ledger_divergence",
        "agent_restart_allocate_ok", "ledger_before_crash"),
    13: ("crash_cycles", "seams", "recovery_modes", "warm_mode",
         "warm_from_checkpoint", "leaked_reservations", "ledger_divergence"),
}


@pytest.mark.parametrize("scenario", [8, 9, 13])
def test_chaos_scenarios_give_the_reference_results(scenario, monkeypatch):
    monkeypatch.setenv("TPUKUBE_CHAOS_SEED", "1337")
    monkeypatch.setenv("TPUKUBE_SNAPSHOT_AUDIT_RATE", "1.0")
    monkeypatch.setenv("TPUKUBE_CRASH_CYCLES", "3")
    want = ref_scenarios.run(scenario)
    got = scenarios.run(scenario)
    assert {k: got[k] for k in SAME[scenario]} == \
        {k: want[k] for k in SAME[scenario]}
    assert got["leaked_reservations"] == 0 and got["ledger_divergence"] == 0
    assert got["snapshot_audit"]["divergences"] == 0
    if scenario == 13:
        assert got["seams"] == ["torn_tail", "clean", "lost_tail"]
        assert got["recovery_modes"] == ["warm"] * 3
        assert got["snapshot_audit"]["checks"] > 0


# scenario 8 on an idle host injects 18 faults at seed 1337 (8 errors, 5
# slow, 2 timeouts, 3 torn writes) on both packages
IDLE_HOST_INJECTED = 18
# past the chaos circuit's 20 ms reset window (ChaosSimCluster.CIRCUIT_RESET_S)
STALL_S = 0.025


def _stalled_sleep(seconds: float) -> None:
    time.sleep(max(seconds, STALL_S))


def test_a_late_wakeup_draws_the_same_extra_faults_on_both_packages(
        monkeypatch):
    """Why test_scenario8_is_deterministic_for_a_seed can fail on a loaded
    host, on either package: the apiserver channel's retry backoff sleeps
    1-10 ms, and the chaos circuit reopens 20 ms after it trips. A sleep
    that wakes late (a busy CPU) finds the circuit half-open, so the retry
    is a probe that draws one more fault, where an idle host's retry is
    refused by the open circuit without a draw. Every backoff here wakes
    25 ms late: both packages then draw the same faults, more than on an
    idle host. The race is the reference's own (the port copies its
    scenario, circuit and retrier), so the port draws as it does."""
    from tpukube.core import retry as ref_retry
    from tpukube_torch.core import retry as port_retry

    monkeypatch.setenv("TPUKUBE_CHAOS_SEED", "1337")
    for mod in (ref_retry, port_retry):
        defaults = list(mod.Retrier.__init__.__defaults__)
        defaults[defaults.index(time.sleep)] = _stalled_sleep
        monkeypatch.setattr(mod.Retrier.__init__, "__defaults__",
                            tuple(defaults))
    want = ref_scenarios.run(8)
    got = scenarios.run(8)
    assert got["faults"] == want["faults"]
    assert got["preemptions"] == want["preemptions"]
    assert got["faults"]["injected"] > IDLE_HOST_INJECTED
    assert got["leaked_reservations"] == 0 and got["ledger_divergence"] == 0
