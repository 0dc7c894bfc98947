"""The rank side of ``tests/test_torch_parallel.py``: a pool of gloo ranks
that run the sharded path of ``xrft_tpu_torch`` on the CPU.

Each rank is a process started once per test module; it joins a gloo
process group, builds the meshes it is told to, and then takes cases from
its own queue until it gets None.  A case is a plain dict (numpy inputs,
dims, coords, keywords); every rank runs it and answers with its block's
shape and placement, the collectives it issued, the kernel entry points the
path called, what the package's telemetry counted (``calls``,
``exchanges``, ``exchange_bytes``, ``chain_shifts``) and (rank 0) the
gathered global result.  A case marked ``unfolded`` runs again with the
shifts after the transform taken off the pencil chain and applied after it
by ``ops.shards``, and says whether each rank's block came out bit for bit
the same.  This module imports torch and xrft_tpu_torch only, never JAX: the
reference values are computed in the pytest process.
"""

from __future__ import annotations

import datetime
import traceback



def _labeled(xt, spec):
    da = xt.LabeledArray(spec["values"], dims=spec["dims"],
                         coords=spec.get("coords") or {},
                         name=spec.get("name"), device="cpu")
    if spec.get("chunks"):
        da = da.chunk(spec["chunks"])
    return da


class _Counter:
    """Counts the calls of a module attribute (a kernel wrapper or a
    collective) while it is installed."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls = 0

    def __enter__(self):
        def counted(*a, **k):
            self.calls += 1
            return self.fn(*a, **k)
        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def _describe(x):
    """(global numpy value, local block shape, {axis: mesh axis}) of a
    tensor; the value is gathered on every rank (a collective)."""
    from xrft_tpu_torch.ops import shards

    full = x.full_tensor() if shards.is_sharded(x) else x
    return (full.detach().resolve_conj().numpy(),
            tuple(shards.local(x).shape), shards.axis_map(x))


def _unfolded(pencil_fftn):
    """``pencil_fftn`` with its shifts after the transform applied by
    ``ops.shards`` once the chain has run, none in the chain."""
    from xrft_tpu_torch.ops import shards

    def run(x, axes, mesh, axis_sharding, kind="fft", precision=None,
            post_shift_axes=(), post_kind="fftshift"):
        out = pencil_fftn(x, axes, mesh, axis_sharding, kind,
                          precision=precision)
        if post_shift_axes:
            post = shards.fftshift if post_kind == "fftshift" \
                else shards.ifftshift
            out = post(out, list(post_shift_axes))
        return out
    return run


def _call(case, mesh):
    """The case's call on this rank: (output tensor, LabeledArray or
    None)."""
    import torch

    import xrft_tpu_torch as xt
    from xrft_tpu_torch import parallel

    fn = case["fn"]
    kw = dict(case.get("kwargs") or {})
    if fn == "pencil_fftn":
        x = torch.as_tensor(case["x"])
        shifts = dict(post_shift_axes=case.get("post_shift_axes", ()),
                      post_kind=case.get("post_kind", "fftshift"))
        out = parallel.pencil_fftn(x, case["axes"], mesh,
                                   case["axis_sharding"], case["kind"],
                                   precision=case.get("precision"),
                                   **shifts)
        if case.get("then"):
            out = parallel.pencil_fftn(out, case["axes"], mesh,
                                       case["axis_sharding"], case["then"],
                                       precision=case.get("precision"))
        return out, None
    arrays = [_labeled(xt, s) for s in case["arrays"]]
    if fn == "local_op":
        from xrft_tpu_torch.ops.window import apply_window

        da = parallel.shard_labeled(arrays[0], mesh, case["dim_shards"])
        if case["op"] == "hann":
            da = apply_window(da, kw["dim"], "hann")[1]
        else:
            da = xt.detrend(da, kw["dim"], case["op"])
    elif fn == "sharded":
        da = parallel.sharded(case["name"], *arrays, *case.get("args", ()),
                              mesh=mesh, dim_shards=case["dim_shards"], **kw)
        if case.get("then"):
            da = parallel.sharded(case["then"], da, mesh=mesh,
                                  dim_shards=case["dim_shards"])
    else:
        da = getattr(parallel, fn)(*arrays, mesh, case["dim_shards"], **kw)
    return da.data, da


def _same_unfolded(case, mesh, out):
    """Whether the case, run with the chain's shifts applied after it,
    gives this rank the same block, bit for bit, in the same placement."""
    import torch

    from xrft_tpu_torch import parallel
    from xrft_tpu_torch.ops import shards
    from xrft_tpu_torch.parallel import api

    folded = api.pencil_fftn
    api.pencil_fftn = parallel.pencil_fftn = _unfolded(folded)
    try:
        again, _ = _call(case, mesh)
    finally:
        api.pencil_fftn = parallel.pencil_fftn = folded
    a, b = shards.local(out).resolve_conj(), shards.local(again).resolve_conj()
    return (shards.axis_map(out) == shards.axis_map(again)
            and a.dtype == b.dtype and torch.equal(a, b))


def _run(case, meshes):
    import torch.distributed as dist

    from xrft_tpu_torch import isotropic, parallel
    from xrft_tpu_torch import telemetry as tm
    from xrft_tpu_torch.config import config
    from xrft_tpu_torch.ops import mirror

    if case["fn"] == "make_mesh":
        mesh = parallel.make_mesh(case["axis_shapes"], device="cpu")
        return {"names": mesh.mesh_dim_names, "shape": tuple(mesh.shape),
                "links": parallel.axis_links(mesh)}
    mesh = meshes[case["mesh"]]
    saved = {k: getattr(config, k) for k in case.get("config", {})}
    for k, v in case.get("config", {}).items():
        setattr(config, k, v)
    spies = [_Counter(dist, "all_to_all_single"),
             _Counter(dist, "all_reduce"),
             _Counter(mirror, "mirror_psd"),
             _Counter(isotropic, "binned_sum"),
             _Counter(isotropic, "binned_sum_plain")]
    undo = []
    if case.get("k6"):
        # K6's route with its launches replayed on the host (k6_replay.py)
        from k6_replay import install

        def patch(obj, name, value):
            undo.append((obj, name, getattr(obj, name)))
            setattr(obj, name, value)

        replayed = install(patch)
    before = tm.snapshot()
    try:
        for s in spies:
            s.__enter__()
        try:
            out, da = _call(case, mesh)
        finally:
            for s in spies:
                s.__exit__()
        after = tm.snapshot()
        launched = replayed.launches if undo else 0
        # under the case's configuration, after the counts are taken
        same = _same_unfolded(case, mesh, out) if case.get("unfolded") \
            else None
    finally:
        for k, v in saved.items():
            setattr(config, k, v)
        for obj, name, value in reversed(undo):
            setattr(obj, name, value)
    counted = {k: after[k] - before[k]
               for k in ("calls", "exchanges", "exchange_bytes",
                         "chain_shifts")}
    value, local_shape, amap = _describe(out)
    res = {"local_shape": local_shape,
           "placement": {a: m for a, m in amap.items()},
           "global_shape": tuple(out.shape),
           "calls": {s.name: s.calls for s in spies},
           "counted": counted,
           "k6_launches": launched,
           "same_as_unfolded": same}
    if dist.get_rank() == 0:
        res["value"] = value
        if da is not None:
            res.update(dims=tuple(da.dims), name=da.name,
                       coords={c: v.values for c, v in da.coords.items()},
                       dtype=str(da.dtype))
    return res


def serve(rank, world, port, mesh_specs, inq, outq):
    """One rank: join the gloo group, build the meshes, answer cases."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=45))
        from xrft_tpu_torch.parallel import make_mesh

        meshes = {name: make_mesh(shape, device="cpu")
                  for name, shape in mesh_specs.items()}
        outq.put((rank, "ready", None))
    except Exception:
        outq.put((rank, "error", traceback.format_exc()))
        return
    while True:
        case = inq.get()
        if case is None:
            break
        try:
            outq.put((rank, "ok", _run(case, meshes)))
        except Exception as e:
            outq.put((rank, "raised", (type(e).__name__, str(e),
                                       traceback.format_exc())))
    dist.destroy_process_group()
