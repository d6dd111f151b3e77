"""The reference's PowerSGD cases on the port's copies.

``tests/test_powersgd.py`` runs on the port (``tests/torch_reference_cases.py``,
its helpers from ``tests/test_averaging.py`` rewritten the same way): the
container format, the power iteration, the factored merge, error feedback
through sync rounds, robust estimators over an attacker, the config checks,
pre-schema deferral and the wire-state checkpoint, on port averagers whose
codec is the device backend on CPU tensors (the power iteration and the
reconstruction run as ``torch.linalg.qr`` and matmuls). The checkpoint case
imports ``Trainer`` in its body; it gets the port's trainer on the CPU.
"""

import pytest
from torch_reference_cases import count_cases, device_codec, port_cases  # noqa: F401

from distributedvolunteercomputing_tpu_torch.training import trainer as trainer_mod

REFERENCE = port_cases("test_powersgd.py", globals(), test_modules=("test_averaging",))


class CpuTrainer(trainer_mod.Trainer):
    """The port's trainer with the CPU asked for."""

    def __init__(self, *args, device="cpu", **kwargs):
        super().__init__(*args, device=device, **kwargs)


@pytest.fixture(autouse=True)
def _cpu_trainer(monkeypatch):
    monkeypatch.setattr(trainer_mod, "Trainer", CpuTrainer)


def test_reference_cases_bind_the_port():
    from distributedvolunteercomputing_tpu_torch.swarm import powersgd
    from distributedvolunteercomputing_tpu_torch.swarm.averager import SyncAverager

    assert REFERENCE["powersgd"] is powersgd and REFERENCE["SyncAverager"] is SyncAverager
    assert count_cases(REFERENCE) == 30
