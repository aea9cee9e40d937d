"""Runs a worker script on N gloo ranks through the port's own launcher
(``python -m paddle_tpu_torch.distributed.launch``), for the port's
multi-rank tests (tests/test_torch_{quant_collective,comms_plan,
collective_train}.py).

Each run gets a free port (bound to port 0, so xdist workers can run side
by side), one CPU thread a rank, a group timeout, and a time limit: on
expiry the launcher's whole process group is killed, and the launcher
kills its ranks when any of them fails, so a dead rank fails the test
instead of hanging it.  The worker imports neither jax nor the test
module.

A worker that reaches its end leaves through os._exit(0) (EPILOGUE),
after its results are written and closed: in the interpreter's teardown
torch's gloo process group can abort a rank whose work is done
("terminate called without an active exception", SIGABRT).  That took
a rank of 5 in about 330 four-rank launches six at a time on 8 cores,
and of none in 300 launches with the epilogue.  A worker that raises
still exits non-zero.
"""

import os
import signal
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# gloo's wait for a peer inside a collective, in each rank
GROUP_TIMEOUT_S = 60


def free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _logs(log_dir):
    if not os.path.isdir(log_dir):
        return ''
    return '\n'.join('--- %s\n%s' % (n, open(os.path.join(log_dir, n)).read())
                     for n in sorted(os.listdir(log_dir)))


class Ranks(object):
    """`nproc` ranks of tmp_path/worker.py (written from `source`),
    started by the port's launcher in a session of their own."""

    def __init__(self, tmp_path, source, nproc, args=(), timeout=150,
                 env=None):
        script = os.path.join(str(tmp_path), 'worker.py')
        with open(script, 'w') as f:
            f.write(source + EPILOGUE)
        self.log_dir = os.path.join(str(tmp_path), 'logs')
        self.nproc, self.timeout = nproc, timeout
        run_env = dict(os.environ)
        run_env.update({'PYTHONPATH': ROOT, 'OMP_NUM_THREADS': '1',
                        'MKL_NUM_THREADS': '1',
                        'PADDLE_DIST_TIMEOUT': str(GROUP_TIMEOUT_S)})
        run_env.update(env or {})
        cmd = [sys.executable, '-m', 'paddle_tpu_torch.distributed.launch',
               '--nproc_per_node', str(nproc),
               '--started_port', str(free_port()), '--log_dir', self.log_dir,
               script] + [str(a) for a in args]
        self.proc = subprocess.Popen(
            cmd, cwd=ROOT, env=run_env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, start_new_session=True)

    def wait(self):
        """Raise AssertionError with every rank's log unless all exit 0
        within the time limit; return the logs."""
        try:
            out, _ = self.proc.communicate(timeout=self.timeout)
        except subprocess.TimeoutExpired:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.communicate()
            raise AssertionError('%d ranks ran past %d s\n%s' % (
                self.nproc, self.timeout, _logs(self.log_dir)))
        logs = _logs(self.log_dir)
        assert self.proc.returncode == 0, '%s\n%s' % (
            out.decode(errors='replace'), logs)
        return logs

    def kill(self):
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.communicate()


def launch(tmp_path, source, nproc, args=(), timeout=150, env=None):
    """Run `source` on `nproc` ranks to the end (Ranks.wait)."""
    return Ranks(tmp_path, source, nproc, args, timeout, env).wait()


# the first lines of every worker: one thread, the port only
PRELUDE = '''
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from paddle_tpu_torch.distributed import init_distributed
group = init_distributed()
rank, world = dist.get_rank(), dist.get_world_size()
assert 'jax' not in sys.modules
'''

# the last lines of every worker (see the module docstring)
EPILOGUE = '''
sys.stdout.flush()
sys.stderr.flush()
os._exit(0)
'''
