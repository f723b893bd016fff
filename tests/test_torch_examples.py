"""The port's six audio examples (``gpuaudiobench_tpu_torch/examples``)
on the CPU, at the JAX examples' test sizes (``tests/test_examples.py``),
each through ``main(argv, device="cpu")`` with its printed proof, and
each held against the JAX example's audio from the same seed (the JAX
example run in this process on the CPU backend, as ``conftest.py``
forces it).

Audio is compared as the examples write it: 16-bit WAVs, each
normalized by its own peak the same way on both sides, so a sample may
differ by the stated tolerance of the full scale plus one step of
rounding. Tolerances (of the peak): modal 1e-4 (the bell and the mesh),
PartConv and the session 1e-3, the TCN 1e-4, FDTD 5e-3. The checkpoint
and the small-room FDTD carry are compared in float32.
"""

import contextlib
import io
import os
import sys
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

CPU = torch.device("cpu")
LSB = 1.0 / 32767.0


def _run(main, argv, **kw):
    """(exit code, stdout) of an example's ``main``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv, **kw)
    return rc, buf.getvalue()


def _wav(path):
    with wave.open(str(path)) as w:
        assert w.getframerate() == 48_000
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
        return pcm.reshape(-1, w.getnchannels()).astype(np.float64) / 32767.0


def _port(name):
    import importlib

    return importlib.import_module(f"gpuaudiobench_tpu_torch.examples.{name}")


def _jax(name):
    import importlib

    return importlib.import_module(f"examples.{name}")


def _both(tmp_path, name, argv, tol, port_kw=None):
    """Runs the JAX example and the port's with ``argv``; asserts both
    exit 0 and their WAVs agree within ``tol`` of full scale plus one
    rounding step. Returns the port's stdout."""
    rc, jout = _run(_jax(name).main, argv + ["--out", str(tmp_path / "j.wav")])
    assert rc == 0, jout
    rc, out = _run(_port(name).main,
                   argv + ["--out", str(tmp_path / "p.wav")]
                   + (port_kw or []), device="cpu")
    assert rc == 0, out
    a, b = _wav(tmp_path / "p.wav"), _wav(tmp_path / "j.wav")
    assert a.shape == b.shape
    assert np.sqrt(np.mean(a ** 2)) > 0.01, "rendered audio is silent"
    err = float(np.abs(a - b).max())
    assert err <= tol + LSB, err
    return out


# -- streaming_synth: the bell, its checkpoint and resume -----------------

BELL = ["--seconds", "1", "--modes", "256"]


def test_streaming_synth_matches_jax(tmp_path):
    out = _both(tmp_path, "streaming_synth", BELL, 1e-4)
    assert "checkpoint/resume bit-exact: True" in out
    assert (tmp_path / "p.state.npz").exists()


def _jax_bell_second_half(modes, seconds=1.0):
    """The JAX example's float32 second half, after its strike."""
    jex = _jax("streaming_synth")
    amp = jex.bell_modes(modes)[0]
    run_blocks, carry = jex.make_stream(*jex.bell_modes(modes))
    n_blocks = max(2, int(seconds * jex.FS / jex.BLOCK))
    half = n_blocks // 2
    carry, _ = run_blocks(carry, half)
    kick = _port("streaming_synth").strike(amp)
    carry = jax.tree.map(lambda c, k: c + k, carry, kick)
    _, second = run_blocks(carry, n_blocks - half)
    return np.asarray(second).ravel(), n_blocks - half


def test_jax_checkpoint_resumes_in_port(tmp_path):
    """The JAX example's mid-stream checkpoint restores into the port's
    carry, and the port's resumed render meets the JAX second half."""
    rc, out = _run(_jax("streaming_synth").main,
                   BELL + ["--out", str(tmp_path / "bell.wav")])
    assert rc == 0, out
    ex = _port("streaming_synth")
    want, n = _jax_bell_second_half(256)
    amp, cos_w, sin_w, re0, im0 = ex.bell_modes(256)
    stream, _ = ex.make_stream(amp, cos_w, sin_w, re0, im0, CPU)
    got = ex.resume(str(tmp_path / "bell.state.npz"), stream,
                    ex.strike(amp), n)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_port_checkpoint_loads_in_jax(tmp_path):
    """The port's checkpoint restores in the JAX package, leaf for leaf."""
    from gpuaudiobench_tpu.harness.checkpoint import load_stream_state

    ex = _port("streaming_synth")
    ckpt = str(tmp_path / "p.state.npz")
    _, ok = ex.render(1.0, 256, 220.0, ckpt, CPU)
    assert ok
    amp, cos_w, sin_w, re0, im0 = ex.bell_modes(256)
    stream, carry = ex.make_stream(amp, cos_w, sin_w, re0, im0, CPU)
    carry, _ = stream.run(carry, ex.blocks_for(1.0)[1])
    template = (np.zeros(256, np.float32), np.zeros(256, np.float32))
    restored, header = load_stream_state(ckpt, template,
                                         benchmark=ex.CHECKPOINT_NAME)
    assert header["n_leaves"] == 2
    for got, want in zip(restored, carry):
        np.testing.assert_array_equal(np.asarray(got), want.numpy())


# -- room_impulse ----------------------------------------------------------

def test_room_impulse_matches_jax(tmp_path):
    """One block of the 52^3 room (the CPU twin takes seconds a block):
    the impulse, the direct path and the gate, as the JAX example."""
    out = _both(tmp_path, "room_impulse", ["--seconds", "0.011"], 5e-3)
    assert "direct path arrives at sample 21" in out
    assert "stable" in out and "UNSTABLE" not in out


def test_room_impulse_carry_matches_jax_in_a_small_room():
    """Eight blocks of a room of 10 (the carried fields across blocks)
    against the JAX package's FDTD block at the same cells."""
    from gpuaudiobench_tpu.ops import fdtd3d as jf

    room, n_blocks = 10, 8
    got = _port("room_impulse").render(n_blocks, CPU, room=room)
    cells = dict(source=jf.source_pos(room), receiver=jf.receiver_pos(room))
    step = jax.jit(lambda x, *f: jf.fdtd3d_block(x, *f, **cells))
    fields = jf.zero_fields(jf.grid_n(room))
    x = jnp.zeros((1, 512), jnp.float32).at[0, 0].set(1.0)
    want = []
    for k in range(n_blocks):
        out, *fields = step(x if k == 0 else jnp.zeros_like(x), *fields)
        want.append(np.asarray(out[0]))
    want = np.concatenate(want)
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() <= 5e-3 * np.abs(want).max()


# -- reverb, ampsim, session -------------------------------------------------

@pytest.mark.parametrize("form", ["ring", "shift", "nupols"])
def test_reverb_matches_jax(tmp_path, form):
    argv = ["--seconds", "1", "--modes", "256", "--rt60", "0.25",
            "--form", form, "--tail-chunk", "4"]
    out = _both(tmp_path, "reverb", argv, 1e-3)
    assert "streamed convolution matches offline: True" in out
    assert f"{form} FDL" in out


def test_ampsim_matches_jax(tmp_path):
    out = _both(tmp_path, "ampsim", ["--seconds", "1", "--layers", "6"],
                1e-4)
    assert "streamed inference matches offline: True" in out


def test_session_matches_jax(tmp_path):
    argv = ["--seconds", "0.7", "--tracks", "4", "--modes", "128",
            "--rt60", "0.3"]
    out = _both(tmp_path, "session", argv, 1e-3)
    assert "streamed session matches offline: True" in out


# -- multichip_synth ----------------------------------------------------------

@pytest.mark.parametrize("ranks", [2, 4])
def test_multichip_synth_on_a_gloo_mesh(tmp_path, ranks):
    """The mode-sharded bank on a gloo mesh: within 1e-6 of the one-rank
    render (printed by the example), one psum of a block's 2 KiB a block,
    and the JAX example's 8-device render within 1e-4."""
    argv = ["--seconds", "0.5", "--modes", "512"]
    out = _both(tmp_path, "multichip_synth", argv, 1e-4,
                port_kw=["--ranks", str(ranks)])
    assert f"sharded over {ranks} rank(s)" in out
    assert "matches one-rank render: True" in out
    assert f"collectives issued: 46 (psum over tp ({ranks} ranks)), " \
        "94208 bytes, 2048 a block" in out


def test_multichip_synth_refuses_an_uneven_split(tmp_path):
    rc, out = _run(_port("multichip_synth").main,
                   ["--modes", "510", "--ranks", "4", "--out",
                    str(tmp_path / "m.wav")], device="cpu")
    assert rc == 1 and "must divide by 4 ranks" in out
