"""RoleMakers: the port's copy of
`paddle_tpu/incubate/fleet/base/role_maker.py` (reference:
python/paddle/fluid/incubate/fleet/base/role_maker.py:30,111,191).

The env contract is the reference launcher's: PADDLE_TRAINER_ID,
PADDLE_TRAINERS_NUM, PADDLE_TRAINER_ENDPOINTS, TRAINING_ROLE and
PADDLE_PSERVERS_IP_PORT_LIST. A "trainer" is one process driving one
device; worker 0's endpoint is where `fleet.init` starts the
torch.distributed process group.
"""

from __future__ import annotations

import os

__all__ = [
    "Role",
    "RoleMakerBase",
    "UserDefinedRoleMaker",
    "PaddleCloudRoleMaker",
]


class Role:
    WORKER = 1
    SERVER = 2


class RoleMakerBase:
    def __init__(self):
        self._worker_endpoints = []
        self._server_endpoints = []
        self._role = Role.WORKER
        self._current_id = 0
        self._generated = False

    def generate_role(self):
        self._generated = True

    def is_worker(self):
        return self._role == Role.WORKER

    def is_server(self):
        return self._role == Role.SERVER

    def is_first_worker(self):
        return self.is_worker() and self._current_id == 0

    def worker_index(self):
        return self._current_id

    def server_index(self):
        return self._current_id

    def worker_num(self):
        return len(self._worker_endpoints) or 1

    def server_num(self):
        return len(self._server_endpoints)

    def get_trainer_endpoints(self):
        return self._worker_endpoints

    def get_pserver_endpoints(self):
        return self._server_endpoints


class UserDefinedRoleMaker(RoleMakerBase):
    """reference: role_maker.py UserDefinedRoleMaker."""

    def __init__(self, current_id=0, role=Role.WORKER, worker_num=1,
                 server_endpoints=None, worker_endpoints=None):
        super().__init__()
        self._current_id = current_id
        self._role = role
        self._server_endpoints = server_endpoints or []
        self._worker_endpoints = (
            worker_endpoints or [f"127.0.0.1:{6170 + i}" for i in range(worker_num)]
        )


class PaddleCloudRoleMaker(RoleMakerBase):
    """reference: role_maker.py:191 — everything from the PADDLE_* env."""

    def __init__(self, is_collective=True):
        super().__init__()
        self._is_collective = is_collective

    def generate_role(self):
        if self._generated:
            return
        self._current_id = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self._worker_endpoints = [e for e in eps.split(",") if e]
        if not self._worker_endpoints:
            n = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
            self._worker_endpoints = [f"127.0.0.1:{6170 + i}" for i in range(n)]
        training_role = os.environ.get("TRAINING_ROLE", "TRAINER")
        self._role = Role.SERVER if training_role == "PSERVER" else Role.WORKER
        self._server_endpoints = [
            e for e in os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "").split(",") if e
        ]
        self._generated = True
