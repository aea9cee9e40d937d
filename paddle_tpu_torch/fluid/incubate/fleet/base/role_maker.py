"""Role makers: who am I in the training job.

Reference: python/paddle/fluid/incubate/fleet/base/role_maker.py —
PaddleCloudRoleMaker (environment based), UserDefinedRoleMaker.  The
PaddleCloud variables are the ones paddle_tpu_torch.distributed.launch
sets; without them the role comes from the process group (one worker
without a group).
"""

import os


class Role(object):
    WORKER = 1
    SERVER = 2


class RoleMakerBase(object):
    def __init__(self):
        self._trainer_endpoints = []
        self._server_endpoints = []
        self._role_is_generated = False

    def generate_role(self):
        self._role_is_generated = True

    def is_worker(self):
        return True

    def is_server(self):
        return False

    def is_first_worker(self):
        return self.worker_index() == 0

    def worker_num(self):
        return 1

    def server_num(self):
        return 0

    def worker_index(self):
        return 0

    def server_index(self):
        return 0

    def get_trainer_endpoints(self):
        return self._trainer_endpoints

    def get_pserver_endpoints(self):
        return self._server_endpoints


class PaddleCloudRoleMaker(RoleMakerBase):
    """The launcher's environment: PADDLE_TRAINER_ID,
    PADDLE_TRAINERS_NUM, PADDLE_TRAINER_ENDPOINTS."""

    def __init__(self, is_collective=True):
        super(PaddleCloudRoleMaker, self).__init__()
        self._is_collective = is_collective

    def generate_role(self):
        if self._role_is_generated:
            return
        import torch.distributed as dist
        grouped = dist.is_available() and dist.is_initialized()
        self._trainer_id = int(os.environ.get(
            'PADDLE_TRAINER_ID', dist.get_rank() if grouped else 0))
        self._worker_num = int(os.environ.get(
            'PADDLE_TRAINERS_NUM', dist.get_world_size() if grouped else 1))
        eps = os.environ.get('PADDLE_TRAINER_ENDPOINTS', '')
        self._trainer_endpoints = eps.split(',') if eps else []
        self._role_is_generated = True

    def worker_index(self):
        self.generate_role()
        return self._trainer_id

    def worker_num(self):
        self.generate_role()
        return self._worker_num


class UserDefinedRoleMaker(RoleMakerBase):
    def __init__(self, current_id=0, role=Role.WORKER, worker_num=1,
                 server_endpoints=None):
        super(UserDefinedRoleMaker, self).__init__()
        self._cur_id = current_id
        self._role = role
        self._worker_num = worker_num
        self._server_endpoints = server_endpoints or []

    def is_worker(self):
        return self._role == Role.WORKER

    def is_server(self):
        return self._role == Role.SERVER

    def worker_index(self):
        return self._cur_id

    def server_index(self):
        return self._cur_id

    def worker_num(self):
        return self._worker_num

    def server_num(self):
        return len(self._server_endpoints)


class UserDefinedCollectiveRoleMaker(UserDefinedRoleMaker):
    def __init__(self, current_id=0, worker_endpoints=None):
        super(UserDefinedCollectiveRoleMaker, self).__init__(
            current_id=current_id, worker_num=len(worker_endpoints or [1]))
        self._trainer_endpoints = worker_endpoints or []
