"""The port's federated observability over worker daemons — the stitched
/explain, the merged /metrics, the wire bill and flight recorder, the
merged timeline, federated /events and the router's listener
(``tpukube_torch/sched/shardworker.py``'s ``make_router_app``) — held
against the reference's.

Twins (``run_twin``, both packages, decision by decision): the tests of
test_federated_obs.py that drive the process transport (its in-process
N=1 test is twinned in tests/test_torch_shard.py). A worker that cannot
spawn fails the port's run."""

import pytest

import test_federated_obs
from torch_refnative import use_private_tpuinfo
from torch_twin import reference_tests, run_twin

use_private_tpuinfo()

FEDERATED_SKIPS = {
    "test_n1_federated_exposition_is_sole_extender_verbatim":
        "in process: twinned in tests/test_torch_shard.py",
}


@pytest.mark.parametrize("fn", reference_tests(test_federated_obs,
                                               FEDERATED_SKIPS),
                         ids=lambda f: f.__name__)
def test_reference_federated_obs_tests_hold_on_the_port(fn):
    run_twin(fn)
