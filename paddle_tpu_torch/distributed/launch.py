"""Multi-process launcher, the port's copy of
`paddle_tpu/distributed/launch.py` (reference:
python/paddle/distributed/launch.py:132,243), stdlib only.

`python -m paddle_tpu_torch.distributed.launch --nproc_per_node=N train.py
args...` spawns N processes with the reference's PADDLE_* env contract
(launch.py:132-227); multi-node wiring comes from
--cluster_node_ips/--node_ip as in the reference. Process-group semantics:

- the FIRST nonzero child exit code, in order of process death, not rank
  order, is the launcher's exit code;
- when one rank dies nonzero, the surviving ranks are killed (SIGTERM, a
  grace window, then SIGKILL): a distributed step cannot complete with a
  member gone;
- SIGTERM/SIGINT to the launcher fan out to every rank (each worker's
  PreemptionHandler turns that into a final snapshot and a clean exit).

`worker_env` / `build_world` / `spawn_workers` / `kill_group` /
`wait_group` / `shrink_candidates` are importable pieces: the elastic
TrainSupervisor (resilience/trainer_fleet.py) spawns through the same env
contract. Nothing here sets up collectives (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time

__all__ = ["worker_env", "spawn_workers", "wait_group", "launch", "main",
           "build_world", "kill_group", "shrink_candidates"]


def shrink_candidates(base_world):
    """Valid shrink targets for a `base_world`-wide elastic job,
    descending: the proper divisors of the ORIGINAL world size. A
    divisor target keeps the global batch EXACT — the surviving world
    scales grad-accum microbatches by base/current (an integer per the
    elastic contract, PADDLE_TPU_BASE_WORLD / PADDLE_TPU_ELASTIC_WORLD
    in resilience.trainer_fleet); a non-divisor world would force a
    per-step global-batch change (documented drift), so the supervisor
    never picks one on its own."""
    base_world = int(base_world)
    return [w for w in range(base_world - 1, 0, -1)
            if base_world % w == 0]


def _parse_args(argv=None):
    p = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    p.add_argument("--cluster_node_ips", type=str, default="127.0.0.1")
    p.add_argument("--node_ip", type=str, default="127.0.0.1")
    p.add_argument("--started_port", type=int, default=6170)
    p.add_argument("--nproc_per_node", type=int, default=1)
    p.add_argument("--selected_devices", type=str, default=None,
                   help="passed to the workers as FLAGS_selected_devices")
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def worker_env(rank, world, selected_devices=None, base_env=None,
               extra=None):
    """The reference's PADDLE_* trainer env contract (launch.py:132-227)
    for one rank. `world` is the full endpoint list (rank-indexed);
    `extra` lays additional vars on top (the TrainSupervisor adds its
    progress-file and attempt vars here)."""
    env = dict(os.environ if base_env is None else base_env)
    env.update({
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_CURRENT_ENDPOINT": world[rank],
        "PADDLE_TRAINERS_NUM": str(len(world)),
        "PADDLE_TRAINER_ENDPOINTS": ",".join(world),
        "FLAGS_selected_devices": selected_devices or "",
    })
    env.update(extra or {})
    return env


def build_world(cluster_node_ips="127.0.0.1", started_port=6170,
                nproc_per_node=1):
    """rank -> endpoint list across every node (launch.py:180 style)."""
    node_ips = [ip.strip() for ip in str(cluster_node_ips).split(",")]
    world = []
    for ip in node_ips:
        for i in range(int(nproc_per_node)):
            world.append(f"{ip}:{int(started_port) + i}")
    return node_ips, world


def spawn_workers(cmd, world, node_id, nproc, *, selected_devices=None,
                  log_dir=None, env_extra=None, per_rank_extra=None,
                  base_env=None):
    """Fork the local ranks of the job. `cmd` is the argv AFTER the
    interpreter (e.g. ['train.py', '--flag']); `per_rank_extra(rank)`
    returns additional env for one rank (progress files etc.);
    `base_env` replaces os.environ as the env the contract lays over.
    Returns the Popen list, local-rank ordered."""
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
    procs = []
    try:
        for local_rank in range(nproc):
            rank = node_id * nproc + local_rank
            extra = dict(env_extra or {})
            if per_rank_extra is not None:
                extra.update(per_rank_extra(rank) or {})
            env = worker_env(rank, world, selected_devices,
                             base_env=base_env, extra=extra)
            full = [sys.executable, "-u"] + list(cmd)
            if log_dir:
                out = open(os.path.join(log_dir,
                                        f"workerlog.{local_rank}"), "ab")
                try:
                    procs.append(subprocess.Popen(full, env=env,
                                                  stdout=out, stderr=out))
                finally:
                    out.close()  # the child holds its own fd now
            else:
                procs.append(subprocess.Popen(full, env=env))
    except BaseException:
        # a later rank's fork failing (EMFILE/ENOMEM, unwritable log)
        # must not strand the ranks already running: the exception
        # discards `procs`, so no caller could ever reap them
        kill_group(procs, grace_s=2.0)
        raise
    return procs


def kill_group(procs, grace_s=5.0):
    """SIGTERM every live process, give the group `grace_s` to drain
    (workers may be committing a final snapshot), then SIGKILL the
    stragglers. Every process is reaped before returning — the launcher
    never exits over a zombie or a still-running orphan rank."""
    live = [p for p in procs if p.poll() is None]
    for p in live:
        try:
            p.terminate()
        except OSError:
            pass
    deadline = time.monotonic() + float(grace_s)
    for p in live:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.05))
        except subprocess.TimeoutExpired:
            p.kill()
    for p in live:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass


def wait_group(procs, *, poll_interval_s=0.05, kill_grace_s=5.0,
               forward_signals=(signal.SIGTERM, signal.SIGINT)):
    """Supervise a spawned rank group to completion. Returns the first
    nonzero exit code in order of DEATH (0 when every rank exits 0).
    A rank dying nonzero kills the survivors; a forwarded SIGTERM/
    SIGINT fans out to every rank and the group drains normally."""
    def _fan_out(signum, frame):
        for p in procs:
            if p.poll() is None:
                try:
                    p.send_signal(signum)
                except OSError:
                    pass

    import threading

    previous = {}
    if threading.current_thread() is threading.main_thread():
        for sig in forward_signals or ():
            previous[sig] = signal.signal(sig, _fan_out)
    try:
        remaining = list(procs)
        while remaining:
            for p in list(remaining):
                rc = p.poll()
                if rc is None:
                    continue
                remaining.remove(p)
                if rc != 0:
                    # first death wins: coordinated kill of the rest,
                    # then propagate THIS rank's code
                    kill_group(remaining, grace_s=kill_grace_s)
                    return rc
            if remaining:
                time.sleep(poll_interval_s)
        return 0
    finally:
        for sig, prev in previous.items():
            signal.signal(sig, prev)


def launch(args):
    node_ips, world = build_world(args.cluster_node_ips, args.started_port,
                                  args.nproc_per_node)
    node_id = node_ips.index(args.node_ip)
    procs = spawn_workers(
        [args.training_script] + list(args.training_script_args),
        world, node_id, args.nproc_per_node,
        selected_devices=args.selected_devices, log_dir=args.log_dir,
    )
    try:
        return wait_group(procs)
    finally:
        kill_group(procs, grace_s=2.0)  # belt-and-braces: no orphan ranks


def main():
    sys.exit(launch(_parse_args()))


if __name__ == "__main__":
    main()
