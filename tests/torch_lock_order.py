"""Runtime lock-order checking for the port's serve and MVCC tests.

``port_lock_order`` runs a test under :func:`repro_torch.analysis.locks.
monitored`: every session, store, engine and telemetry the test builds
runs on instrumented locks, as do the module-level leaf locks (the build
lock and the launch and collective counters), and the test fails on any
acquisition against the declared order (LCK001-LCK003).  A test module
turns it on for all of its tests with::

    from torch_lock_order import port_lock_order  # noqa: F401
    pytestmark = pytest.mark.usefixtures("port_lock_order")
"""
import pytest

from repro_torch.analysis.locks import monitored


@pytest.fixture
def port_lock_order():
    with monitored() as mon:
        yield mon
    assert not mon.violations, [str(v) for v in mon.violations]
