"""The work of each kernel: the operations it does and the bytes it must
move, from its shapes (and, for B5, the slots its data makes valid).

One function per kernel, read alike by the kernel's bound in
``chip_smoke.py`` (operations over the card's peak, bytes over its memory
rate), by the FLOP formula registered for its ``torch.library`` op
(:mod:`repro_torch.roofline.trace` counts with it) and so by the dry run's
roofline. Each returns ``(operations, bytes)``.

The bytes count each input read once and each output written once. The
operations count what the algorithm needs: for B1-B3 the reference
decode's fold (px = c Wpx, pxy = Wpy px^T, h pxy), for B4 and B5 the two
products of every (row, key) pair the masks keep, for B4b the five of the
backward, for B6 and B6b the f32
arithmetic per (step, channel, state), an exponential counted as one.
"""
from __future__ import annotations

F32 = 4


def policy_score_counts(b: int, q: int, z: int, d: int, *,
                        folded: bool = True) -> tuple[int, int]:
    """B1: c (b, q, d), h (b, z, d), Wpx and Wpy (d, d), the f32 mask (b,
    q) read, the (b, z, q) f32 scores written. ``folded=False``: the work
    of B1's first design, py = h Wpy recomputed."""
    if folded:
        flops = 2 * b * (q * d * d + d * d * q + z * d * q)
    else:
        flops = 2 * b * (q * d * d + z * d * d + z * q * d)
    return flops, _head_in_bytes(b, q, z, d) + F32 * b * z * q


def policy_score_decode_counts(b: int, q: int, z: int, d: int,
                               k: int) -> tuple[int, int]:
    """B3: B1's inputs and fold; the top ``k`` indices (int32) and values
    (f32) of each of the b * z rows written."""
    return (2 * b * (q * d * d + d * d * q + z * d * q),
            _head_in_bytes(b, q, z, d) + 8 * b * z * k)


def policy_score_bwd_counts(b: int, q: int, z: int, d: int, *,
                            folded: bool = True) -> tuple[int, int]:
    """B2: B1's inputs, the (b, z, q) upstream gradient and forward output
    read; dc, dh and the two weight gradients written. Its kernel's fold:
    six b*q x d x d products and three b*z x q x d ones;
    ``folded=False``: three of each of b*q x d x d, b*z x d x d and b*z x
    q x d."""
    if folded:
        flops = 2 * b * (6 * q * d * d + 3 * z * q * d)
    else:
        flops = 2 * b * (3 * q * d * d + 3 * z * d * d + 3 * z * q * d)
    return flops, (_head_in_bytes(b, q, z, d) + 8 * b * z * q
                   + F32 * (b * q * d + b * z * d + 2 * d * d))


def _head_in_bytes(b, q, z, d):
    return F32 * (b * q * d + b * z * d + 2 * d * d) + F32 * b * q


def attention_pairs(b: int, s: int, sk: int, causal: bool,
                    window) -> int:
    """The (row, key) pairs B4's masks keep, per head: causal with an
    optional window (columns from the top left, ``col <= row`` and
    ``col > row - window``), or every key."""
    if not causal:
        return b * s * sk
    w = s if window is None else min(window, s)
    return b * (w * (w + 1) // 2 + (s - w) * w)


def flash_attention_counts(b: int, s: int, sk: int, h: int, kv: int,
                           hd: int, *, causal: bool = True, window=None,
                           itemsize: int = 2,
                           with_lse: bool = False) -> tuple[int, int]:
    """B4: QK^T and PV over the kept pairs of each of the h heads; q, k, v
    read and the output written in ``itemsize``-byte elements, and with
    ``with_lse`` the (b, h, s) f32 log-sum-exp written."""
    flops = 4 * h * hd * attention_pairs(b, s, sk, causal, window)
    nbytes = itemsize * (2 * b * s * h * hd + 2 * b * sk * kv * hd)
    return flops, nbytes + (F32 * b * h * s if with_lse else 0)


def flash_attention_bwd_counts(b: int, s: int, sk: int, h: int, kv: int,
                               hd: int, *, causal: bool = True, window=None,
                               itemsize: int = 2) -> tuple[int, int]:
    """B4b: the five products of the kept pairs of each of the h heads (S =
    QK^T, dP = dO V^T, dV = P^T dO, dQ = dS K, dK = dS^T Q); q, out and
    dout, k and v read in ``itemsize``-byte elements and the (b, h, s) f32
    log-sum-exp read, dq, dk and dv written in the inputs' elements."""
    flops = 10 * h * hd * attention_pairs(b, s, sk, causal, window)
    q_like, kv_like = b * s * h * hd, b * sk * kv * hd
    return flops, (itemsize * (4 * q_like + 4 * kv_like)
                   + F32 * b * h * s)


def decode_attention_counts(b: int, w: int, h: int, kv: int, hd: int, *,
                            n_valid=None, window=None, itemsize: int = 2,
                            with_lse: bool = False) -> tuple[int, int]:
    """B5: q . k and p v over the ``n_valid`` valid (lane, slot) pairs of
    each head; their K and V rows, q, slot_pos (b, w) and pos (b,) read,
    the output (and with ``with_lse`` the (b, h) f32 log-sum-exp) written.
    ``n_valid`` is what the run's slot positions make valid; without it,
    every lane holds min(w, window) valid slots, a filled cache."""
    if n_valid is None:
        n_valid = b * (w if window is None else min(w, window))
    flops = 4 * h * hd * n_valid
    nbytes = (2 * itemsize * n_valid * kv * hd + 2 * itemsize * b * h * hd
              + F32 * b * w + F32 * b)
    return flops, nbytes + (F32 * b * h if with_lse else 0)


def mamba_scan_counts(b: int, s: int, d: int, n: int) -> tuple[int, int]:
    """B6's bare entry: u and dt read and y written, f32, 12 bytes per
    (t, c); B, C, A read and h_last written once; 8 operations per (t, c,
    n)."""
    return (8 * b * s * d * n,
            F32 * (3 * b * s * d + 2 * b * s * n + d * n + b * d * n))


def mamba_scan_gated_counts(b: int, s: int, d: int, n: int, *,
                            z_itemsize: int = 2,
                            chunks: int = 0) -> tuple[int, int]:
    """B6's gated entry: u and dt_raw f32 and z read and the output written
    in z's dtype per (t, c); B, C, A, dt_bias and D read and h_last written
    once; with ``chunks`` the state entering each chunk, (b, chunks, d, n)
    f32, written. 8 operations per (t, c, n) and 9 per (t, c) for the
    softplus, the D skip and the gate."""
    return ((8 * n + 9) * b * s * d,
            b * s * d * (2 * F32 + 2 * z_itemsize)
            + F32 * (2 * b * s * n + d * n + 2 * d + b * d * n
                     + b * chunks * d * n))


def mamba_scan_gated_bwd_counts(b: int, s: int, d: int, n: int, chunks: int,
                                *, z_itemsize: int = 2) -> tuple[int, int]:
    """B6b: u and dt_raw f32, z and dout read and du, d dt_raw f32 and dz
    written per (t, c); B and C read and dB and dC written, 16 bytes per
    (t, n); the chunk states read; A, D, dt_bias read and their gradients
    written once. 15 operations per (t, c, n) (the state's recompute, the
    adjoint and the five sums) and 30 per (t, c) (softplus, SiLU and their
    derivatives)."""
    return (15 * b * s * d * n + 30 * b * s * d,
            b * s * d * (4 * F32 + 3 * z_itemsize) + 4 * F32 * b * s * n
            + F32 * b * chunks * d * n + 2 * F32 * (d * n + 2 * d))
