"""K1's work assignment (xrft_tpu_torch/csrc/mirror.cu) replayed in numpy
on the CPU: one block per (batch element, source row pair (r, r') with
r' = (NY - r) mod NY, chunk of stored columns), each reading its two rows
once and writing four segments (both rows directly, each row mirrored into
the other's output row), a segment wrapping around the row end at most
once.  The replay must write every output element exactly once and give
mirror_psd_plain's bits.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xrft_tpu_torch.ops import mirror

SCALE = 0.37


def _segments(ny, nx, shift, cap):
    """The segments of every block of one batch element, as the kernel
    computes them: (output row, start column, length, source row, offset of
    value 0 in the chunk, direction, k0)."""
    hy, hx = (ny // 2, nx // 2) if shift else (0, 0)
    nh = nx // 2 + 1
    nchunks = -(-nh // cap)
    cw = -(-nh // nchunks)
    for r in range(ny // 2 + 1):
        rp = 0 if r == 0 else ny - r
        for chunk in range(nchunks):
            k0, k1 = chunk * cw, min(nh, chunk * cw + cw)
            oy = r + hy if r + hy < ny else r + hy - ny
            oyp = rp + hy if rp + hy < ny else rp + hy - ny
            ox0 = k0 + hx if k0 + hx < nx else k0 + hx - nx
            yield oy, ox0, k1 - k0, r, 0, 1, k0
            if rp != r:
                yield oyp, ox0, k1 - k0, rp, 0, 1, k0
            km0, km1 = max(k0, 1), min(k1, (nx + 1) // 2)
            if km1 > km0:
                c = nx - km1 + 1 + hx
                start = c if c < nx else c - nx
                yield oyp, start, km1 - km0, r, km1 - 1 - k0, -1, k0
                if rp != r:
                    yield oy, start, km1 - km0, rp, km1 - 1 - k0, -1, k0


def _replay(p, nx, shift, cap):
    """Run the schedule on the power half spectrum p[B, NY, MH]; returns the
    output and how often each element was written."""
    B, ny, _ = p.shape
    out = np.full((B, ny, nx), np.nan, p.dtype)
    writes = np.zeros((B, ny, nx), np.int64)
    for oy, start, n, src, off, step, k0 in _segments(ny, nx, shift, cap):
        n1 = min(n, nx - start)                 # store_seg's wrap split
        for lo, cnt, c0 in ((0, n1, start), (n1, n - n1, 0)):
            assert 0 <= c0 and c0 + cnt <= nx
            j = np.arange(lo, lo + cnt)
            cols = c0 + np.arange(cnt)
            out[:, oy, cols] = p[:, src, k0 + off + step * j]
            writes[:, oy, cols] += 1
    return out, writes


@pytest.mark.parametrize("shift", [True, False])
@pytest.mark.parametrize("ny", [1, 2, 3, 4, 5, 6, 7, 8, 9, 64])
def test_pair_schedule_matches_plain(ny, shift):
    """NX in 1..12 and 78, MH beyond NX//2 + 1, B > 1, column chunks of the
    kernel's width and of a few columns (several chunks per row)."""
    rng = np.random.RandomState(ny)
    for nx in list(range(1, 13)) + [78]:
        mh = nx // 2 + 3
        B = 3 if ny % 2 else 2
        F = (rng.randn(B, ny, mh) + 1j * rng.randn(B, ny, mh)) \
            .astype(np.complex64)
        Ft = torch.from_numpy(F)
        want = mirror.mirror_psd_plain(Ft, nx, shift, SCALE).numpy()
        p = ((Ft.real ** 2 + Ft.imag ** 2) * SCALE).numpy()
        for cap in (1, 2, 5, 4096):
            got, writes = _replay(p, nx, shift, cap)
            assert (writes == 1).all(), (nx, cap)
            np.testing.assert_array_equal(got, want, err_msg=f"{nx} {cap}")


def test_pair_schedule_reads_each_row_once():
    """Each stored column k <= NX//2 of each source row is read exactly
    once: a block's direct segment of a row is the range it loads."""
    for ny in (1, 2, 7, 8, 64):
        for nx in (1, 2, 9, 78):
            for cap in (3, 4096):
                reads = np.zeros((ny, nx // 2 + 1), np.int64)
                for _, _, n, src, _, step, k0 in _segments(ny, nx, True, cap):
                    if step == 1:
                        reads[src, k0:k0 + n] += 1
                assert (reads == 1).all(), (ny, nx, cap)


def test_float64_schedule_matches_plain():
    rng = np.random.RandomState(11)
    F = rng.randn(2, 7, 8) + 1j * rng.randn(2, 7, 8)
    Ft = torch.from_numpy(F)
    for shift in (True, False):
        want = mirror.mirror_psd_plain(Ft, 13, shift, SCALE).numpy()
        p = ((Ft.real ** 2 + Ft.imag ** 2) * SCALE).numpy()
        got, writes = _replay(p, 13, shift, 2)
        assert (writes == 1).all()
        np.testing.assert_array_equal(got, want)
