"""Pencil-decomposed distributed N-D FFT over a DeviceMesh.

Counterpart of ``xrft_tpu/parallel/pencil.py``.  Transform axes sharded over
mesh axes are handled by the pencil decomposition: every per-axis FFT is
local (the axis is made fully resident first), and residency moves between
axes through ``all_to_all`` transposes.  The **forward chain**: each sharded
transform axis hands its mesh sharding forward to a divisible, unsharded
destination axis with ONE all_to_all and leaves it there, so the output's
sharding differs from the input's.  That layout evolution is the host
function :func:`plan_forward_layout` of (shape, axes, sharding, mesh), so
the inverse kinds walk the same plan backwards and end in the original
layout.  An axis with no divisible destination falls back to a transpose and
back ("roundtrip"), padding its buddy axis as needed.

:func:`pencil_fftn` works on each rank's ``to_local()`` block: each step's
exchange is one all_to_all on the mesh axis's process group
(:func:`.exchange.all_to_all`, issued asynchronously), with the tiled
semantics of ``jax.lax.all_to_all`` (the split axis is cut
into P chunks, chunk j goes to rank j, and what arrives is concatenated
along the concat axis in rank order).  The local FFTs go through
:mod:`..ops.fft_core` under ``config.fft_impl``: cuFFT ("torch"), the
kernels K2 (float32) and K4 (float64) ("kernel"), or the matmul engines
("matmul": stacked where it can plan, the pair engine otherwise, irfft
included).  ``config.pencil_overlap_chunks > 1`` splits each
(all_to_all, FFT) pair into chunks along the largest resident axis and
issues each chunk's all_to_all asynchronously, so that it runs while the
previous chunk's FFT does.  The shift asked after the transform
(``post_shift_axes``) rides the exchange that splits a transformed axis
again, as a rotation of which chunk goes to which rank, wherever half the
axis is a whole number of chunks.
"""

from __future__ import annotations

import torch

from .. import telemetry
from ..config import config
from ..ops import fft_core, shards
from . import exchange

__all__ = ["pencil_fftn", "plan_forward_layout"]


def _pick_dest(ndim, axis, sharding, global_shape, P_size, transform_axes,
               done_axes, banned=(), reserve_sizes=()):
    """Forward-chain destination for the sharding leaving ``axis``: a
    currently-unsharded axis whose *global* extent divides P_size (its
    local extent is then divisible too, shard_map sees local shapes).
    Preference order: (0) settled axes (batch or already-transformed)
    that no pending DCN move will need, (1) settled axes a pending
    DCN-sharded axis could park on (``reserve_sizes`` = those moves'
    mesh-axis sizes — occupying the only such destination would force the
    DCN move into a 2-collective fallback over the slow inter-slice
    links), (2) yet-untransformed transform axes (the sharding must then
    move again).  Returns the destination axis or None (-> round-trip
    fallback)."""
    cands = []
    for b in range(ndim):
        if b == axis or b in banned or sharding.get(b):
            continue
        if global_shape[b] % P_size != 0:
            continue
        if b in transform_axes and b not in done_axes:
            rank = 2
        elif any(global_shape[b] % s == 0 for s in reserve_sizes):
            rank = 1
        else:
            rank = 0
        cands.append((rank, b))
    if not cands:
        return None
    return min(cands)[1]


def plan_forward_layout(global_shape, axes, axis_sharding, mesh_shape,
                        banned=(), axis_links=None):
    """The deterministic layout evolution of the forward chain: returns
    (steps, final_sharding) where each step describes one transform axis
    as ('local', a) | ('move', a, dest, mesh_axis) |
    ('roundtrip', a, mesh_axis).  ``banned`` axes never receive a sharding
    (the real rfft/irfft axis must stay local).

    ``axis_links`` ({mesh_axis: 'ici'|'dcn'}, see ``mesh.axis_links``)
    makes the plan topology-aware: per-axis FFTs commute, so the chain is
    ordered **DCN-last** — every ICI-sharded (and unsharded) axis is
    transformed first, so by the time a DCN-sharded axis must hand its
    sharding forward, the already-transformed axes are settled
    destinations and its (unavoidable) inter-slice all_to_all happens
    exactly once; a DCN move also never parks on a yet-untransformed
    transform axis while a settled one exists (see :func:`_pick_dest`).
    The step order IS the compute order in :func:`pencil_fftn`, and every
    caller (including the mirror-sharding reconstruction in
    ``spectra._hermitian_expand``) derives it from this one function."""
    links = axis_links or {}
    ndim = len(global_shape)
    sharding = dict(axis_sharding)
    # stable DCN-last ordering of the chain (ties keep caller order)
    axes = sorted(axes, key=lambda a: 1 if links.get(
        sharding.get(a), "ici") == "dcn" else 0)
    steps = []
    done = set()
    for i, a in enumerate(axes):
        m = sharding.get(a)
        if m is None:
            steps.append(("local", a))
        else:
            # sizes of the pending DCN moves (axes still to transform,
            # sharded over a DCN mesh axis): an ICI move should not squat
            # on the destinations those will need
            reserve = {mesh_shape[sharding[a2]] for a2 in axes[i + 1:]
                       if sharding.get(a2) is not None
                       and links.get(sharding[a2], "ici") == "dcn"}
            if links.get(m, "ici") == "dcn":
                reserve = ()
            dest = _pick_dest(ndim, a, sharding, global_shape,
                              mesh_shape[m], set(axes), done, banned,
                              reserve_sizes=reserve)
            if dest is None:
                steps.append(("roundtrip", a, m))
            else:
                steps.append(("move", a, dest, m))
                del sharding[a]
                sharding[dest] = m
        done.add(a)
    return steps, sharding


def _a2a_start(v: torch.Tensor, group, split_axis: int,
               rotate: bool = False):
    """Issue the tiled all_to_all of ``v`` over ``group`` asynchronously:
    the split axis is moved first and made contiguous, so that
    ``all_to_all_single``'s equal split of dim 0 is the tiled split.
    ``rotate`` writes the send buffer half a turn round the split axis, so
    that rank j gets chunk j + P/2 (mod P) instead of chunk j: for an even
    number P of ranks that is the axis's fftshift (and its ifftshift), in
    the same one copy."""
    moved = v.movedim(split_axis, 0)
    if rotate:
        h = moved.shape[0] // 2
        send = moved.new_empty(moved.shape)
        send[:h].copy_(moved[h:])
        send[h:].copy_(moved[:h])
    else:
        send = moved.contiguous()
    recv = torch.empty_like(send)
    return exchange.all_to_all(recv, send, group, async_op=True), recv


def _a2a_finish(pending, shape, parts, split_axis, concat_axis):
    """Wait for :func:`_a2a_start`'s exchange and lay what arrived out as
    ``jax.lax.all_to_all(tiled=True)`` does: the split axis 1/P as long, the
    concat axis the P blocks in rank order."""
    issued, recv = pending
    issued.wait()
    rest = [n for i, n in enumerate(shape) if i != split_axis]
    out = recv.reshape([parts, shape[split_axis] // parts] + rest)
    out = out.movedim(1, split_axis + 1).movedim(0, concat_axis)
    new = list(shape)
    new[split_axis] //= parts
    new[concat_axis] *= parts
    return out.reshape(new)


def _split_chunks(x, axis, k):
    n = x.shape[axis]
    sizes = [n // k + (1 if i < n % k else 0) for i in range(k)]
    return list(torch.split(x, sizes, dim=axis))


def pencil_fftn(x, axes, mesh, axis_sharding: dict, kind: str = "fft",
                precision: str | None = None, post_shift_axes=(),
                post_kind: str = "fftshift"):
    """Distributed N-D FFT of a (globally viewed) array.

    Parameters
    ----------
    x : a DTensor on ``mesh`` in the layout the kind expects (below), or a
        plain tensor holding the global array on every rank (each keeps its
        block of it).
    axes : transform axes.  For 'rfft'/'irfft' the real axis is ``axes[-1]``
        and must be both the trailing axis and unsharded.
    mesh : torch.distributed DeviceMesh
    axis_sharding : {array_axis: mesh_axis_name} describing the
        *space-domain* layout: for forward kinds this is the input's
        sharding; for inverse kinds it is the layout the OUTPUT returns to
        (the input must be in the forward chain's final layout; a DTensor
        in any other layout raises).
    kind : 'fft' | 'ifft' | 'rfft' | 'irfft'
    precision : None (the data's own dtype) or "hp": complex128 (float64
        for an irfft's output) through the same chain, the port's float64
        path.
    post_shift_axes, post_kind : axes to ``"fftshift"`` or ``"ifftshift"``
        after the transform.  The exchange that splits a transformed axis
        (a move's split axis, a roundtrip's return) over an even number of
        ranks sends each rank the chunk half a turn away, so that axis's
        shift costs no exchange of its own (``telemetry``'s
        ``chain_shifts`` counts those axes); every other axis is shifted
        after the chain by :mod:`..ops.shards`, locally where it is
        resident.

    Returns a DTensor: the forward kinds in the planned final layout, the
    inverse kinds in the space layout.  The real axis of an 'rfft' is
    resident by contract, so its transform runs first and the chain moves
    the half spectrum (``xrft_tpu/parallel/pencil.py:305-315`` chains the
    real input and transforms the real axis last); the values are the same.
    """
    ndim = x.ndim
    axes = [a % ndim for a in axes]
    axis_sharding = {a % ndim: m for a, m in axis_sharding.items() if m}
    if kind not in ("fft", "ifft", "rfft", "irfft"):
        raise ValueError(f"unknown kind {kind!r}")
    if kind in ("rfft", "irfft"):
        if axes[-1] != ndim - 1:
            raise ValueError(f"{kind} axis must be the last axis")
        if axis_sharding.get(ndim - 1):
            raise ValueError(f"the real ({kind}) axis must be unsharded")

    inverse = kind in ("ifft", "irfft")
    # the chained (pencil) axes exclude the trailing real axis, always local
    chain_axes = axes[:-1] if kind in ("rfft", "irfft") else axes
    banned = (ndim - 1,) if kind in ("rfft", "irfft") else ()
    from .mesh import axis_links

    sizes = shards.mesh_shape(mesh)
    shape = tuple(x.shape)
    # the chain runs on the half spectrum of an rfft (its real axis first)
    chain_shape = shape[:-1] + (shape[-1] // 2 + 1,) if kind == "rfft" \
        else shape
    steps, final_sharding = plan_forward_layout(
        chain_shape, chain_axes, axis_sharding, sizes, banned,
        axis_links=axis_links(mesh))
    layout_in, layout_out = (final_sharding, axis_sharding) if inverse \
        else (axis_sharding, final_sharding)
    for a, m in layout_in.items():
        if shape[a] % sizes[m]:
            raise ValueError(
                f"pencil FFT: axis {a} of extent {shape[a]} does not divide "
                f"into the {sizes[m]} ranks of mesh axis {m!r}")

    if shards.is_sharded(x):
        if x.device_mesh != mesh or shards.axis_map(x) != layout_in:
            raise ValueError(
                f"pencil {kind}: the input is sharded as "
                f"{shards.axis_map(x)}; this plan expects {layout_in}")
        xl = x.to_local()
    else:
        xl = x
        for a, m in layout_in.items():
            lo, hi = shards.chunk_range(shape[a], sizes[m],
                                        mesh.get_local_rank(m))
            xl = xl.narrow(a, lo, hi - lo)
    if precision == "hp":
        xl = xl.to(torch.float64 if kind == "rfft" and not xl.is_complex()
                   else torch.complex128)

    core_kind = "ifft" if inverse else "fft"
    overlap = max(int(config.pencil_overlap_chunks), 1)
    shifted = {a % ndim for a in post_shift_axes}
    transformed, folded = set(), set()

    def folds(split_axis, m):
        """Whether the exchange that splits the transformed, resident
        ``split_axis`` over mesh axis ``m`` applies the axis's shift, once:
        half the axis is a whole number of chunks when the ranks are even
        in number (the plan splits only axes that divide into them), and
        every later step moves whole blocks of it or transforms other
        axes, so the shift stays."""
        if split_axis in shifted and split_axis not in folded \
                and sizes[m] % 2 == 0:
            folded.add(split_axis)
            return True
        return False

    def fft_local(v, a):
        core = fft_core.fftn if core_kind == "fft" else fft_core.ifftn
        return core(v, [a])

    def a2a_fft(v, m, split_axis, concat_axis, fft_axis, banned,
                fft_first=False, rotate=False):
        """all_to_all + local FFT (FFT then all_to_all for the inverse
        chain), in ``overlap`` chunks whose exchanges are issued
        asynchronously: chunk i's all_to_all runs while the FFT of chunk
        i-1 (forward) or chunk i+1 (inverse) does.  ``rotate``: each
        exchange shifts the split axis (:func:`_a2a_start`)."""
        group, parts = mesh.get_group(m), sizes[m]
        ca = None
        if overlap > 1:
            cands = [(v.shape[i], i) for i in range(ndim)
                     if i not in banned and v.shape[i] >= overlap]
            ca = max(cands)[1] if cands else None
        chunks = [v] if ca is None else _split_chunks(v, ca, overlap)

        def finish(p, c):
            return _a2a_finish(p, c.shape, parts, split_axis, concat_axis)

        if fft_first:
            done = [fft_local(c, fft_axis) for c in chunks[:1]]
            pending = [_a2a_start(done[0], group, split_axis, rotate)]
            for c in chunks[1:]:
                done.append(fft_local(c, fft_axis))
                pending.append(_a2a_start(done[-1], group, split_axis,
                                          rotate))
            outs = [finish(p, c) for p, c in zip(pending, done)]
        else:
            pending = [_a2a_start(chunks[0], group, split_axis, rotate)]
            outs = []
            for i, c in enumerate(chunks):
                if i + 1 < len(chunks):
                    pending.append(_a2a_start(chunks[i + 1], group,
                                              split_axis, rotate))
                outs.append(fft_local(finish(pending[i], c), fft_axis))
        return outs[0] if len(outs) == 1 else torch.cat(outs, ca)

    def run_step(out, step):
        if step[0] == "local":
            return fft_local(out, step[1])
        if step[0] == "move":
            _, a, dest, m = step
            if inverse:
                # reverse: FFT while `a` is resident, then hand the
                # sharding back from dest to a
                return a2a_fft(out, m, split_axis=a, concat_axis=dest,
                               fft_axis=a, banned={a, dest}, fft_first=True,
                               rotate=folds(a, m))
            return a2a_fft(out, m, split_axis=dest, concat_axis=a,
                           fft_axis=a, banned={a, dest},
                           rotate=dest in transformed and folds(dest, m))
        # round-trip fallback, with zero-padding of the buddy
        _, a, m = step
        group, parts = mesh.get_group(m), sizes[m]
        b, pad_amt = _rt_buddy(ndim, a, axis_sharding, out.shape, parts)
        orig = out.shape[b]
        if pad_amt:
            zeros = list(out.shape)
            zeros[b] = pad_amt
            out = torch.cat([out, out.new_zeros(zeros)], dim=b)
        out = _a2a_finish(_a2a_start(out, group, b), out.shape, parts, b, a)
        out = fft_local(out, a)
        out = _a2a_finish(_a2a_start(out, group, a, folds(a, m)), out.shape,
                          parts, a, b)
        if pad_amt:
            out = out.narrow(b, 0, orig)
        return out

    order = list(reversed(steps)) if inverse else steps
    out = xl
    if kind == "rfft":
        out = fft_core.rfftn(out, [ndim - 1])
    for step in order:
        out = run_step(out, step)
        transformed.add(step[1])
    if kind == "irfft":
        # the chained axes walked back on the half spectrum; the real axis
        # is resident, so its inverse is local
        out = fft_core.irfftn(out, [ndim - 1])

    out_shape = list(chain_shape)
    if kind == "irfft":
        out_shape[-1] = 2 * (shape[-1] - 1)
    out = shards.wrap(mesh, out, layout_out, out_shape)
    if folded:
        telemetry.count("chain_shifts", len(folded))
    rest = [a for a in post_shift_axes if a % ndim not in folded]
    if rest:
        post = shards.fftshift if post_kind == "fftshift" \
            else shards.ifftshift
        out = post(out, rest)
    return out


def _rt_buddy(ndim, axis, axis_sharding, local_shape, P_size):
    """Round-trip-fallback buddy (round-1 scheme): the axis needing the
    least zero-padding, preferring unsharded hosts."""
    cands = [b for b in range(ndim) if b != axis]
    if not cands:
        raise ValueError(
            f"pencil FFT needs a buddy axis to transpose axis {axis}; "
            f"a 1-D sharded transform has none (shapes {local_shape})."
        )

    def cost(b):
        pad = (-local_shape[b]) % P_size
        return (
            0 if pad == 0 else 1,
            0 if not axis_sharding.get(b) else 1,
            pad / max(local_shape[b], 1),
        )

    b = min(cands, key=cost)
    return b, (-local_shape[b]) % P_size
