"""Multi-process launcher and the rank's process group.

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node N \\
        train.py [script arguments]

Reference: python/paddle/distributed/launch.py (one trainer process per
card with the PaddleCloud environment).  Each rank gets:

- the PaddleCloud contract: ``PADDLE_TRAINER_ID``,
  ``PADDLE_TRAINERS_NUM``, ``PADDLE_CURRENT_ENDPOINT``,
  ``PADDLE_TRAINER_ENDPOINTS`` and ``FLAGS_selected_gpus`` (its card);
- the ``torch.distributed`` rendezvous: ``MASTER_ADDR``,
  ``MASTER_PORT`` (the first node's ``--started_port``), ``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, and
  ``PADDLE_LOCAL_GPUS``, the cards of all local ranks.

Local rank i takes card ``selected_gpus[i % len(selected_gpus)]``
(default: every visible card), so ranks share cards when there are
more ranks than cards.  The launcher polls every rank: when one exits
with an error the others are terminated, and it exits non-zero.  A rank
is killed if the launcher dies.

``init_distributed`` makes the rank's process group.  Its backend rule:
NCCL when every local rank has a card of its own; gloo when local ranks
share a card (NCCL refuses two ranks on one device) or the rank runs on
``CPUPlace`` or without CUDA.  A rank that shares a card still computes
on it; only its collectives' transport goes through the host (gloo
moves CUDA tensors through host memory, distributed/wire.py).
"""

import argparse
import datetime
import os
import signal
import subprocess
import sys
import time

DEFAULT_TIMEOUT_S = 600


def _parse_args(argv=None):
    p = argparse.ArgumentParser(
        description='paddle_tpu_torch distributed launcher')
    p.add_argument('--cluster_node_ips', type=str, default='127.0.0.1')
    p.add_argument('--node_ip', type=str, default='127.0.0.1')
    p.add_argument('--started_port', type=int, default=6170)
    p.add_argument('--selected_gpus', type=str, default=None,
                   help='cards the local ranks take, round robin '
                        '(default: every visible card)')
    p.add_argument('--nproc_per_node', type=int, default=1)
    p.add_argument('--log_dir', type=str, default=None)
    p.add_argument('training_script', type=str)
    p.add_argument('training_script_args', nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _cards(selected):
    if selected:
        return [int(c) for c in selected.split(',') if c.strip()]
    import torch
    return list(range(torch.cuda.device_count()))


def _die_with_parent():
    """In the child before exec: SIGKILL when the launcher dies."""
    try:
        import ctypes
        ctypes.CDLL('libc.so.6', use_errno=True).prctl(1, signal.SIGKILL)
    except OSError:
        pass


def rank_env(args, local_rank, cards):
    """The environment of local rank `local_rank`."""
    ips = args.cluster_node_ips.split(',')
    node_id = ips.index(args.node_ip) if args.node_ip in ips else 0
    nproc = args.nproc_per_node
    rank = node_id * nproc + local_rank
    local = [cards[i % len(cards)] for i in range(nproc)] if cards else []
    return {
        'PADDLE_TRAINER_ID': str(rank),
        'PADDLE_TRAINERS_NUM': str(len(ips) * nproc),
        'PADDLE_CURRENT_ENDPOINT': '%s:%d' % (
            args.node_ip, args.started_port + local_rank),
        'PADDLE_TRAINER_ENDPOINTS': ','.join(
            '%s:%d' % (ip, args.started_port + r)
            for ip in ips for r in range(nproc)),
        'FLAGS_selected_gpus': str(local[local_rank]) if local else '',
        'PADDLE_LOCAL_GPUS': ','.join(str(c) for c in local),
        'MASTER_ADDR': ips[0],
        'MASTER_PORT': str(args.started_port),
        'RANK': str(rank),
        'WORLD_SIZE': str(len(ips) * nproc),
        'LOCAL_RANK': str(local_rank),
        'LOCAL_WORLD_SIZE': str(nproc),
    }


def launch(argv=None):
    args = _parse_args(argv)
    cards = _cards(args.selected_gpus)
    procs = []

    def _terminate(signum, frame):
        raise SystemExit(128 + signum)

    signal.signal(signal.SIGTERM, _terminate)
    rc = 0
    try:
        for local_rank in range(args.nproc_per_node):
            env = dict(os.environ)
            env.update(rank_env(args, local_rank, cards))
            cmd = [sys.executable, '-u', args.training_script] + \
                args.training_script_args
            logf = None
            if args.log_dir:
                os.makedirs(args.log_dir, exist_ok=True)
                logf = open(os.path.join(args.log_dir, 'worker.%s.log'
                                         % env['RANK']), 'w')
            procs.append((subprocess.Popen(
                cmd, env=env, stdout=logf, stderr=subprocess.STDOUT
                if logf else None, preexec_fn=_die_with_parent), logf))
        # poll every rank: one that fails tears the job down while its
        # peers may still wait in a collective
        live = set(range(len(procs)))
        while live:
            for i in sorted(live):
                code = procs[i][0].poll()
                if code is None:
                    continue
                live.discard(i)
                if code != 0:
                    raise RuntimeError('rank %d exited with code %d'
                                       % (i, code))
            time.sleep(0.1)
    except RuntimeError as e:
        sys.stderr.write('paddle_tpu_torch.distributed.launch: %s\n' % e)
        rc = 1
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.terminate()
        for p, logf in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            if logf:
                logf.close()
    return rc


# ------------------------------------------------------------ the rank

def local_card():
    """This rank's card: FLAGS_selected_gpus, else LOCAL_RANK, else 0."""
    sel = os.environ.get('FLAGS_selected_gpus', '')
    if sel:
        return int(sel.split(',')[0])
    return int(os.environ.get('LOCAL_RANK', '0'))


def choose_backend(place=None):
    """'gloo' for CPUPlace, without CUDA, or when local ranks share a
    card; 'nccl' when every local rank has a card of its own."""
    import torch
    from ..fluid import core
    if isinstance(place, core.CPUPlace) or not torch.cuda.is_available():
        return 'gloo'
    local = [c for c in os.environ.get('PADDLE_LOCAL_GPUS', '').split(',')
             if c]
    if local:
        shared = len(set(local)) < len(local)
    else:
        shared = int(os.environ.get('LOCAL_WORLD_SIZE', '1')) > \
            torch.cuda.device_count()
    return 'gloo' if shared else 'nccl'


def init_distributed(place=None):
    """Join the job's process group (the launcher's environment), once.
    Returns the world group, or None for a job of one rank (no
    WORLD_SIZE > 1 or no MASTER_ADDR).  The group times out after
    PADDLE_DIST_TIMEOUT seconds (default 600), so a rank whose peer
    died fails instead of waiting."""
    import torch
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.group.WORLD
    world = int(os.environ.get('WORLD_SIZE', '1'))
    if world <= 1 or not os.environ.get('MASTER_ADDR'):
        return None
    rank = int(os.environ['RANK'])
    backend = choose_backend(place)
    if backend == 'nccl':
        torch.cuda.set_device(local_card())
    timeout_s = float(os.environ.get('PADDLE_DIST_TIMEOUT',
                                     DEFAULT_TIMEOUT_S))
    dist.init_process_group(
        backend, init_method='tcp://%s:%s' % (os.environ['MASTER_ADDR'],
                                              os.environ['MASTER_PORT']),
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    sys.stderr.write(
        'paddle_tpu_torch.distributed: rank %d of %d, backend %s (local '
        'cards %s)\n' % (rank, world, backend,
                         os.environ.get('PADDLE_LOCAL_GPUS') or 'none'))
    return dist.group.WORLD


def world_size():
    """Ranks in the job's group (1 without a group)."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


if __name__ == '__main__':
    sys.exit(launch())
