"""Uniformly partitioned overlap-save (UPOLS) streaming convolution: the
convolution-reverb engine of PartConv and DAWSessionMix's send bus.

PyTorch counterpart of ``gpuaudiobench_tpu/ops/partconv.py``, every
function of it, with its shapes and its schedule. The JAX package runs
these as plain XLA (no Pallas kernel), so they are plain PyTorch here:
``torch.fft.rfft`` / ``irfft`` at N = 2B (cuFFT on the card) and the
complex multiply-accumulate as elementwise products summed over the
partition axis.

* The frequency-domain delay line (FDL) and the IR spectra are float32
  re / im planes of shape (T, P, B+1), as in the reference, so f16 H,
  the ``fdlBytes`` metadata and the cost model stay the reference's. An
  f16 H is multiplied as it is stored: the product with an f32 plane
  promotes inside the elementwise kernel, with no f32 copy of H.
* ``partconv_block`` (shift form) is functional: ``torch.cat`` builds
  the moved delay line.
* ``partconv_block_ring`` and the nupols block write their delay-line
  slots IN PLACE (the reference's ``dynamic_update_slice`` on a buffer
  XLA aliases), so no block copies a whole plane. A caller that runs a
  block more than once from one state (a device tier, a stream, the
  overlap check) gives each run its own copy (``clone_state``).
* The ring head and the nupols block phase and ring slot are Python
  ints: the slices they pick cost no device read, and the reference's
  ``jnp.where(fire, ...)`` on small arrays is a Python branch. The
  window rfft / irfft of the nupols tail still run every block and are
  used only on fire blocks, so a block costs the same at every phase
  (the reference's schedule; the p99 deadline verdict reads it).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def num_partitions(ir_length: int, block_size: int) -> int:
    return max(1, -(-ir_length // block_size))


def _planes(spec: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A complex spectrum as contiguous float32 (re, im) planes."""
    return spec.real.contiguous(), spec.imag.contiguous()


def partition_spectra(ir: torch.Tensor, block_size: int):
    """(T, L) IRs -> float32 re/im spectra of shape (T, P, B+1): partition
    p holds rfft([ir[pB:(p+1)B], zeros(B)])."""
    t, length = ir.shape
    b = block_size
    p = num_partitions(length, b)
    padded = torch.zeros((t, p * b), dtype=torch.float32, device=ir.device)
    padded[:, :length] = ir
    parts = padded.reshape(t, p, b)
    seg = torch.cat([parts, torch.zeros_like(parts)], dim=-1)
    return _planes(torch.fft.rfft(seg, dim=-1))


def _forward_spectrum(x: torch.Tensor, prev: torch.Tensor):
    seg = torch.cat([prev, x], dim=1)  # (T, 2B) overlap-save
    return _planes(torch.fft.rfft(seg, dim=1))


def _inverse_block(y_re: torch.Tensor, y_im: torch.Tensor,
                   b: int) -> torch.Tensor:
    y_full = torch.fft.irfft(torch.complex(y_re, y_im), 2 * b, dim=1)
    return y_full[:, b:].contiguous()


def _mac(f_re, f_im, h_re, h_im):
    """Y = sum over the partition axis of F * H, complex, as re / im."""
    y_re = torch.sum(f_re * h_re - f_im * h_im, dim=1)
    y_im = torch.sum(f_re * h_im + f_im * h_re, dim=1)
    return y_re, y_im


def partconv_block(x, prev, fdl_re, fdl_im, h_re, h_im):
    """One block, SHIFT form (the default): the delay line moves one slot.

    x, prev (T, B) the current and previous input blocks; fdl_re/fdl_im
    (T, P, B+1) past input spectra, newest first; h_re/h_im (T, P, B+1)
    from ``partition_spectra`` (f32 or f16). Returns (y, fdl_re',
    fdl_im'); the caller carries (x, fdl') as the next (prev, fdl). The
    inputs are not written."""
    b = x.shape[1]
    sre, sim = _forward_spectrum(x, prev)
    fdl_re = torch.cat([sre[:, None], fdl_re[:, :-1]], dim=1)
    fdl_im = torch.cat([sim[:, None], fdl_im[:, :-1]], dim=1)
    y_re, y_im = _mac(fdl_re, fdl_im, h_re, h_im)
    return _inverse_block(y_re, y_im, b), fdl_re, fdl_im


def ring_aligned_spectra(h_re, h_im):
    """(T, P, bins) spectra -> (T, 2P, bins) doubled, index-negated planes
    for ``partconv_block_ring``: H2[j] = H[(-j) mod P], so the alignment
    H[(head - s) mod P], s = 0..P-1, is the window H2[P-head : 2P-head]."""
    p = h_re.shape[1]
    idx = torch.from_numpy((-np.arange(2 * p)) % p).to(h_re.device)
    return (torch.index_select(h_re, 1, idx),
            torch.index_select(h_im, 1, idx))


def partconv_block_ring(x, prev, head: int, fdl_re, fdl_im, h2_re, h2_im):
    """Ring form (``--partconvForm ring``): the new spectrum overwrites
    slot (head + 1) mod P of fdl_re/fdl_im IN PLACE; slot s then holds the
    spectrum of (head' - s) mod P blocks ago, and H is read through the
    window H2[P-head' : 2P-head'] of ``ring_aligned_spectra``. ``head`` is
    a Python int. Returns (y, head', fdl_re, fdl_im)."""
    b = x.shape[1]
    p = fdl_re.shape[1]
    sre, sim = _forward_spectrum(x, prev)
    head = (head + 1) % p
    fdl_re[:, head] = sre
    fdl_im[:, head] = sim
    y_re, y_im = _mac(fdl_re, fdl_im, h2_re[:, p - head:2 * p - head],
                      h2_im[:, p - head:2 * p - head])
    return _inverse_block(y_re, y_im, b), head, fdl_re, fdl_im


# --- Non-uniform (two-level Gardner) form ------------------------------


def nupols_tail_partitions(ir_length: int, block_size: int, k: int) -> int:
    """Number of K*B-tap tail partitions (0 when the K-slot head covers
    the whole IR; callers run the shift form then)."""
    head_taps = k * block_size
    if ir_length <= head_taps:
        return 0
    return -(-(ir_length - head_taps) // head_taps)


def nupols_group_len(m: int, k: int) -> int:
    """Per-block share of the m >= 1 tail slots: L = ceil((M-1)/K)."""
    return max(1, -(-(m - 1) // k))


def nupols_spectra(ir: torch.Tensor, block_size: int, k: int):
    """(T, L) IRs -> (head, tail) spectra: head (T, K, B+1) planes of
    exactly K B-tap partitions, tail (T, 1+K*L, K*B+1) planes of K*B-tap
    partitions, zero past the M real ones. Needs L > K*B."""
    t, length = ir.shape
    head_taps = k * block_size
    head_ir = torch.zeros((t, head_taps), dtype=torch.float32,
                          device=ir.device)
    n = min(length, head_taps)
    head_ir[:, :n] = ir[:, :n]
    head = partition_spectra(head_ir, block_size)
    t_re, t_im = partition_spectra(ir[:, head_taps:].float(), head_taps)
    mm = t_re.shape[1]
    want = 1 + k * nupols_group_len(mm, k)
    if want > mm:
        pad = torch.zeros((t, want - mm, t_re.shape[2]), dtype=torch.float32,
                          device=ir.device)
        t_re = torch.cat([t_re, pad], dim=1)
        t_im = torch.cat([t_im, pad], dim=1)
    return head, (t_re, t_im)


def make_partconv_block_nupols(block_size: int, k: int, m: int):
    """The nupols block for (B, K, M): ``block_fn(x, state, hh_re, hh_im,
    ht_re, ht_im) -> (y, state')``, the reference's schedule.

    State (the reference's 14 leaves, in its order; ``nupols_init_state``):
      prev        (T, B)        previous input block (head overlap-save)
      hfdl_re/im  (T, K, B+1)   head FDL (shift form)
      blk         int           block phase in [0, K)
      latest      int           ring slot of the newest chunk spectrum
      last_re/im  (T, KB+1)     the newest chunk spectrum
      chunk_full  (T, KB)       the previous completed input chunk
      chunk_fill  (T, KB)       the chunk being filled this window
      g_re/g_im   (T, 2M, KB+1) doubled index-negated tail FDL
      acc_re/im   (T, KB+1)     spread partial MAC for the next window
      tail_out    (T, KB)       tail output of the current window

    Every block: the head's shift block; the window spectrum of
    [chunk_full, chunk_fill] (taken as the newest chunk spectrum on fire
    blocks, blk == 0, with the ring slot advanced); the newest spectrum
    written IN PLACE into its G slot and the +M twin (the same values on
    non-fire blocks); the window output from acc + the m = 0 term,
    inverse-transformed (kept on fire, which also zeroes acc); this
    phase's L-slot share of the m >= 1 MAC into acc; the output block
    y_head + the tail output's slice at the phase; x written into the
    chunk being filled (after the rotation on fire). Only g_re and g_im
    are written in place; every other leaf comes back as a new tensor.
    """
    kb = k * block_size
    ell = nupols_group_len(m, k)
    b = block_size

    def block_fn(x, state, hh_re, hh_im, ht_re, ht_im):
        (prev, hfdl_re, hfdl_im, blk, latest, last_re, last_im,
         chunk_full, chunk_fill, g_re, g_im, acc_re, acc_im, tail_out) = state
        fire = blk == 0

        y_head, hfdl_re, hfdl_im = partconv_block(
            x, prev, hfdl_re, hfdl_im, hh_re, hh_im)

        # The window spectrum, every block; taken on fire only.
        sre, sim = _planes(torch.fft.rfft(
            torch.cat([chunk_full, chunk_fill], dim=1), dim=1))
        if fire:
            latest = (latest + 1) % m
            last_re, last_im = sre, sim
        j_w = (m - latest) % m
        for j in (j_w, j_w + m):
            g_re[:, j] = last_re
            g_im[:, j] = last_im

        # The window output, every block; kept on fire.
        h0r, h0i = ht_re[:, 0], ht_im[:, 0]
        y_re = acc_re + last_re * h0r - last_im * h0i
        y_im = acc_im + last_re * h0i + last_im * h0r
        t_new = _inverse_block(y_re, y_im, kb)
        if fire:
            tail_out = t_new
            acc_re = torch.zeros_like(acc_re)
            acc_im = torch.zeros_like(acc_im)

        # This phase's share of the m >= 1 slots, toward the next window:
        # G indices (m_lo - 1 - latest) mod M onwards, one window.
        m_lo = 1 + blk * ell
        j0 = (m_lo - 1 - latest) % m
        d_re, d_im = _mac(g_re[:, j0:j0 + ell], g_im[:, j0:j0 + ell],
                          ht_re[:, m_lo:m_lo + ell],
                          ht_im[:, m_lo:m_lo + ell])
        acc_re = acc_re + d_re
        acc_im = acc_im + d_im

        y = y_head + tail_out[:, blk * b:(blk + 1) * b]
        if fire:
            chunk_full = chunk_fill
            chunk_fill = torch.zeros_like(chunk_fill)
        else:
            chunk_fill = chunk_fill.clone()
        chunk_fill[:, blk * b:(blk + 1) * b] = x
        blk = (blk + 1) % k

        return y, (x, hfdl_re, hfdl_im, blk, latest, last_re, last_im,
                   chunk_full, chunk_fill, g_re, g_im, acc_re, acc_im,
                   tail_out)

    return block_fn


def nupols_init_state(tracks: int, block_size: int, k: int, m: int):
    """Zero state for ``make_partconv_block_nupols`` as NumPy arrays (the
    two scalars as Python ints), the reference's leaves in its order. The
    ring starts at slot m-1, so the first fire advances it to slot 0."""
    kb = k * block_size
    z = np.zeros
    return (z((tracks, block_size), np.float32),
            z((tracks, k, block_size + 1), np.float32),
            z((tracks, k, block_size + 1), np.float32),
            0,
            m - 1,
            z((tracks, kb + 1), np.float32),
            z((tracks, kb + 1), np.float32),
            z((tracks, kb), np.float32),
            z((tracks, kb), np.float32),
            z((tracks, 2 * m, kb + 1), np.float32),
            z((tracks, 2 * m, kb + 1), np.float32),
            z((tracks, kb + 1), np.float32),
            z((tracks, kb + 1), np.float32),
            z((tracks, kb), np.float32))


def state_to_device(state, device: torch.device):
    """A state of NumPy arrays and ints -> tensors on ``device`` (each a
    copy) and Python ints (0-dim arrays, e.g. a JAX state's int32
    scalars, become ints)."""
    return tuple(int(a) if np.ndim(a) == 0
                 else torch.from_numpy(np.array(a, np.float32)).to(device)
                 for a in state)


def clone_state(state):
    """A copy of a state that an in-place block may write: every tensor
    cloned, ints kept."""
    return tuple(a.clone() if isinstance(a, torch.Tensor) else a
                 for a in state)
