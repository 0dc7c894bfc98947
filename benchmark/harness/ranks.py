"""Runs across several cards: one process per card, in lockstep.

A cell whose mix names a ``mesh`` runs as ``chips`` ranks.  The launching
process (:func:`launch`) touches no card: it holds the rendezvous (a
``TCPStore`` on 127.0.0.1 at a free port), starts one process per card with
``spawn``, and watches them.  Rank r measures card r and joins two process
groups: the default one (NCCL, bound to its card; gloo on the CPU in the
harness's tests), which the port's mesh and collectives use, and a gloo
group that carries the harness's own control messages, so that no control
message adds a device kernel to a trace.  Both take a finite timeout.

Every call of a rank ends with its synchronize and one control message
(:meth:`Team.step`): rank 0's decision to go on or stop and any rank's
failure go to all ranks, so all make the same calls.  Rank 0 hands its
result to the launcher, which prints it once every rank has exited 0.  A
rank that exits otherwise, or dies, makes the launcher end the others and
exit with its code.
"""

from __future__ import annotations

import datetime
import multiprocessing
import multiprocessing.connection
import os
import sys
from dataclasses import dataclass

import torch
import torch.distributed as dist

from . import device

HOST = "127.0.0.1"
GRACE_S = 10             # a rank's time to end after SIGTERM, then SIGKILL


@dataclass
class Launch:
    """How the ranks start.  ``make_device(chips, rank)`` gives a rank's
    device; ``wrap(entry, rank)``, where given, wraps the entry each rank
    calls (the tests plant faults with it); ``timeout_s`` is the control
    group's timeout, the default group's is three times it: a rank that
    waits on a control message for longer gives up, before a rank stuck
    in a collective would."""
    make_device: object = device.Cuda
    wrap: object = None
    timeout_s: float = 60.0


class Solo:
    """The one process of a one-card cell: no group, no message."""
    rank = 0
    world = 1

    def step(self, failed: bool, done: bool) -> tuple[bool, bool]:
        return failed, done

    def agree(self, go: bool) -> bool:
        return go


class Team(Solo):
    """A rank's view of the other ranks: the control group's messages."""

    def __init__(self, rank: int, world: int, group):
        self.rank, self.world, self.group = rank, world, group

    def _max(self, values) -> list:
        t = torch.tensor(values, dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t.tolist()

    def step(self, failed: bool, done: bool) -> tuple[bool, bool]:
        """(any rank failed, rank 0 is done) after a call."""
        f, d = self._max([float(failed), float(done and self.rank == 0)])
        return f > 0, d > 0

    def agree(self, go: bool) -> bool:
        """Rank 0's ``go``, on every rank."""
        return self._max([float(go and self.rank == 0)])[0] > 0

    def max(self, values) -> list:
        """The largest of each value over the ranks."""
        return self._max([float(v) for v in values])

    def gather(self, value) -> list:
        """Every rank's ``value`` (a picklable object), in rank order."""
        out = [None] * self.world
        dist.all_gather_object(out, value, group=self.group)
        return out


def _rank_main(target, args, rank: int, world: int, port: int, opts: Launch,
               conn) -> None:
    """One rank: its device, the two groups, ``target(team, dev, *args)``;
    rank 0 sends the target's result to the launcher."""
    dev = opts.make_device(world, rank)
    store = dist.TCPStore(HOST, port, world, is_master=False,
                          timeout=datetime.timedelta(seconds=opts.timeout_s))
    dist.init_process_group(
        dev.backend, store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=3 * opts.timeout_s),
        device_id=dev.device if dev.kind == "cuda" else None)
    group = dist.new_group(backend="gloo", timeout=datetime.timedelta(
        seconds=opts.timeout_s))
    if dev.kind == "cpu":
        torch.set_num_threads(1)        # the tests' ranks share the CPU
    team = Team(rank, world, group)
    result = target(team, dev, *args)
    dist.barrier(group=group)
    dist.destroy_process_group()
    if rank == 0:
        conn.send(result)


def _end(procs) -> None:
    procs = [p for p in procs if p.pid is not None]
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(GRACE_S)
        if p.is_alive():
            p.kill()
            p.join()


def launch(target, args: tuple, world: int, opts: Launch, log) -> tuple:
    """Runs ``target(team, dev, *args)`` on ``world`` ranks; returns (exit
    code, rank 0's result), the result None unless every rank exited 0."""
    opts.make_device.check(world)
    ctx = multiprocessing.get_context("spawn")
    store = dist.TCPStore(HOST, 0, world, is_master=True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=opts.timeout_s))
    recv, send = ctx.Pipe(duplex=False)
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(target, args, r, world, store.port, opts,
                               send if r == 0 else None))
             for r in range(world)]
    result = None
    env = dict(os.environ)
    try:
        # the ranks read and write Python's bytecode where this process
        # does: they import torch before any line of theirs runs
        if sys.pycache_prefix:
            os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix
        if not sys.dont_write_bytecode:
            os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
        # the rendezvous and the groups' sockets stay on this host
        for name in ("GLOO_SOCKET_IFNAME", "NCCL_SOCKET_IFNAME"):
            os.environ.setdefault(name, "lo")
        # a sharded chain frees and takes blocks of many sizes (exchange
        # buffers, cuFFT's workspaces): at 2048^3 over four cards the
        # caching allocator's fixed segments held 16 GiB free but unusable
        # when a call ran out of memory; expandable segments map freed
        # memory back in.  max_memory_allocated() reads the same either way
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
        for p in procs:
            p.start()
        send.close()
        while True:
            ready = multiprocessing.connection.wait(
                [p.sentinel for p in procs if p.exitcode is None]
                + ([recv] if not recv.closed else []), timeout=1.0)
            if recv in ready:
                try:
                    result = recv.recv()
                except EOFError:
                    pass
                recv.close()
            bad = [p for p in procs if p.exitcode not in (None, 0)]
            if bad:
                log(f"rank {procs.index(bad[0])} exited with "
                    f"{bad[0].exitcode}; ending the others")
                return max(bad[0].exitcode, 1), None
            if all(p.exitcode == 0 for p in procs) and recv.closed:
                return 0, result
    finally:
        os.environ.clear()
        os.environ.update(env)
        _end(procs)
        if not recv.closed:
            recv.close()
        del store
