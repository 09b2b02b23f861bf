"""The port's scheduler held against the reference's by the reference's
fuzz, stress, type, config and deploy tests, run on both packages with
``run_twin``: test_fuzz.py (seeded lifecycle, vGPU-share and DCN-gang
churn with the ledger invariants checked after every op), test_stress.py
(its threads race, so the chips bound are compared, not their order;
``test_v5p_2048_scale_budget`` holds the port to the reference's wall
budgets), test_types.py, test_config.py (its YAML test through the port's
``read_yaml``) and test_deploy.py (the manifests in ``deploy/`` against
the port's config defaults)."""

import pytest

import test_config
import test_deploy
import test_fuzz
import test_stress
import test_types
from torch_refnative import use_private_tpuinfo
from torch_twin import TMP_PATH, reference_cases, run_twin, value_fixtures

use_private_tpuinfo()


@pytest.mark.parametrize(
    "fn,params",
    reference_cases(test_fuzz, {}) + reference_cases(test_types, {})
    + reference_cases(test_config, {}) + reference_cases(test_deploy, {}))
def test_reference_tests_hold_on_the_port(fn, params):
    run_twin(fn, {**TMP_PATH, **value_fixtures(params)})


@pytest.mark.parametrize("fn,params", reference_cases(test_stress, {}))
def test_reference_stress_tests_hold_on_the_port(fn, params):
    run_twin(fn, value_fixtures(params), ordered=False)
