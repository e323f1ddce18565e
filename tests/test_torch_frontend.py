"""The port's front end and stacked matmul against the JAX package, on the CPU.

``log10_mel_plain`` (the plain version of the fused log-mel kernel) against
JAX's ``log10_mel_pallas`` in interpret mode on the same frames: atol 2e-4
on the log10 values within 6 decades of the row's loudest cell (JAX's own
bound for the kernel, ``test_pallas.py``), and atol 2e-3 on every cell: 6
to 8.3 decades down the DFT's f32 sums cancel, and the two f32
formulations differ there by up to 8.7e-4. The witness for that limit is a
float64 FFT of the same frames: each formulation stays within 2e-4 of it
on the loud cells and within 1e-3 on every cell;
the port's ``log_mel_spectrogram`` against JAX's at atol 1e-4 (f32 sums in
another order); ``stacked_matmul_plain`` against ``stacked_matmul_pallas``
at atol 1e-4 (f32). The CUDA kernel's FFT (``K.mel_fft_plan``, emulated
in float32) is held to the same float64 witness and to JAX's kernel.
Inputs are seeded numpy arrays handed to both.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from whisper_timestamped_tpu import audio as JA  # noqa: E402
from whisper_timestamped_tpu.ops.pallas_kernels import log10_mel_pallas, stacked_matmul_pallas  # noqa: E402
from whisper_timestamped_tpu_torch import audio as TA  # noqa: E402
from whisper_timestamped_tpu_torch.ops import kernels as K  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _audio(seed, seconds, rows, pcm):
    """(rows, n) noise plus a tone, as float or as int16 PCM."""
    rng = np.random.default_rng(seed)
    n = int(round(16000 * seconds))
    t = np.arange(n) / 16000.0
    x = 0.2 * np.sin(2 * np.pi * (220.0 + 40 * np.arange(rows))[:, None] * t)
    x = (x + 0.05 * rng.standard_normal((rows, n))).astype(np.float32)
    return np.round(x * 32767).astype(np.int16) if pcm else x


def _log10_mel_f64(row, n_mels, n_frames, n_fft=TA.N_FFT):
    """(n_mels, n_frames) log10 mel power of one padded row, every step in
    float64: periodic Hann window, ``np.fft.rfft``, the mel filterbank."""
    idx = np.arange(n_frames)[:, None] * TA.HOP_LENGTH + np.arange(n_fft)[None, :]
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
    spec = np.fft.rfft(row.astype(np.float64)[idx] * window, axis=-1)
    mel = (spec.real**2 + spec.imag**2) @ TA.mel_filters(n_mels, n_fft=n_fft).T.astype(np.float64)
    return np.log10(np.maximum(mel, 1e-10)).T


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("seconds,rows,pcm", [(1.0, 1, False), (7.3, 3, True), (31.0, 1, True),
                                              (31.0, 3, False)])
def test_log10_mel_plain_matches_pallas(n_mels, seconds, rows, pcm):
    """The same frames through JAX's kernel (interpret mode), one row at a
    time, and through the port's plain version, the whole stack at once;
    both beside a float64 FFT."""
    audio = _audio(int(seconds * 10) + rows, seconds, rows, pcm)
    x = TA._padded_audio(torch.from_numpy(audio), 0, TA.N_FFT // 2)
    cos_b, sin_b, mel_w = TA._front_end_constants(n_mels, TA.N_FFT, torch.device("cpu"))
    ours = K.log10_mel_plain(x, cos_b, sin_b, mel_w, TA.HOP_LENGTH).numpy()
    n_frames = audio.shape[-1] // TA.HOP_LENGTH
    assert ours.shape == (rows, n_mels, n_frames)
    idx = np.arange(n_frames)[:, None] * TA.HOP_LENGTH + np.arange(TA.N_FFT)[None, :]
    for r in range(rows):
        ref = np.asarray(log10_mel_pallas(jnp.asarray(x[r].numpy()[idx]), n_mels, interpret=True))
        loud = ours[r] >= ours[r].max() - 6.0
        np.testing.assert_allclose(ours[r][loud], ref.T[loud], rtol=0, atol=2e-4)
        np.testing.assert_allclose(ours[r], ref.T, rtol=0, atol=2e-3)
        exact = _log10_mel_f64(x[r].numpy(), n_mels, n_frames)
        for got in (ours[r], ref.T):
            np.testing.assert_allclose(got[loud], exact[loud], rtol=0, atol=2e-4)
            np.testing.assert_allclose(got, exact, rtol=0, atol=1e-3)


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("seconds,rows,pcm,padding", [
    (0.5, 2, False, 0), (2.5, 2, True, 48000), (7.3, 3, True, 0), (12.0, 2, False, 0),
    (31.0, 1, True, 0), (31.0, 3, False, 16000)])
def test_log10_mel_plain_near_float64(n_mels, seconds, rows, pcm, padding):
    """The port's plain version against a float64 FFT of the same padded
    rows, with and without trailing zeros: atol 2e-4 within 6 decades of the
    row's loudest cell, 1e-3 on every cell."""
    audio = _audio(int(seconds * 10) + 7 * rows, seconds, rows, pcm)
    x = TA._padded_audio(torch.from_numpy(audio), padding, TA.N_FFT // 2)
    consts = TA._front_end_constants(n_mels, TA.N_FFT, torch.device("cpu"))
    ours = K.log10_mel_plain(x, *consts, TA.HOP_LENGTH).numpy()
    n_frames = (audio.shape[-1] + padding) // TA.HOP_LENGTH
    assert ours.shape == (rows, n_mels, n_frames)
    for r in range(rows):
        exact = _log10_mel_f64(x[r].numpy(), n_mels, n_frames)
        loud = exact >= exact.max() - 6.0
        np.testing.assert_allclose(ours[r][loud], exact[loud], rtol=0, atol=2e-4)
        np.testing.assert_allclose(ours[r], exact, rtol=0, atol=1e-3)


def _fft_plan_log10_mel(frames, n_fft, n_mels, refine_below=K.MEL_REFINE_BELOW):
    """(n_frames, n_mels) log10 mel of frames (n_frames, n_fft) through
    ``K.mel_fft_plan``'s passes in float32, as csrc/log10_mel.cu takes them:
    the plan's window, the (even, odd) samples as
    n_fft / 2 complex values, one Stockham pass a radix with the plan's
    twiddles (its output in natural bin order), the split into the real
    signal's bins, the power; the bins below ``refine_below`` of their
    frame's largest power taken again from the f32 DFT product against the
    plain version's bases; the filters."""
    radices, tw, window = K.mel_fft_plan(n_fft)
    W = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    N = n_fft // 2
    xw = frames.astype(np.float32) * window
    z = (xw[:, 0::2] + 1j * xw[:, 1::2]).astype(np.complex64)
    ns = 1
    for R in radices:
        j = np.arange(N // R)
        k = j % ns
        v = np.stack([z[:, j + r * (N // R)] for r in range(R)], -1)
        v = v * W[k[:, None] * np.arange(R) * (n_fft // (ns * R))]
        dft = np.exp(-2j * np.pi * np.outer(np.arange(R), np.arange(R)) / R).astype(np.complex64)
        v = v @ dft.T
        z = np.empty_like(z)
        for r in range(R):
            z[:, (j - k) * R + k + r * ns] = v[..., r]
        ns *= R
    k = np.arange(N // 2 + 1)
    a, c = z[:, k], z[:, (N - k) % N]
    fe, u = (a + np.conj(c)) * np.float32(0.5), W[k] * ((a - np.conj(c)) * np.complex64(-0.5j))
    power = np.empty((len(frames), N + 1), np.float32)
    power[:, N - k] = (fe - u).real ** 2 + (fe - u).imag ** 2
    power[:, k] = (fe + u).real ** 2 + (fe + u).imag ** 2
    refine = power < refine_below * power.max(axis=1, keepdims=True)
    if refine.any():
        cos_b, sin_b = TA._dft_bases(n_fft)
        rows = frames[refine.any(axis=1)].astype(np.float32)
        re, im = rows @ cos_b, rows @ sin_b
        power[refine] = (re * re + im * im)[refine[refine.any(axis=1)]]
    mel = power @ TA.mel_filters(n_mels, n_fft=n_fft).T
    return np.log10(np.maximum(mel, 1e-10))


MEL_SIGNALS = {  # (tone amplitude, noise amplitude)
    "tone and noise": (0.2, 0.05), "noise": (0.0, 0.05), "wide range": (0.5, 1e-4)}


@pytest.mark.parametrize("signal", sorted(MEL_SIGNALS))
@pytest.mark.parametrize("n_fft", [400, 512])
def test_mel_fft_plan_near_float64(n_fft, signal):
    """The FFT kernel's arithmetic, emulated in float32 from its plan, on 2 s
    of each signal plus 1 s of zeros: within 2e-4 of a float64 FFT on the
    cells within 6 decades of the row's loudest and 1e-3 on every cell
    above the max - 8 floor, and within the same limits of JAX's
    DFT-matmul kernel in interpret mode. (Below the floor, which the
    caller's clamp sets, the wide-range signal's cells 11 decades down
    differ from float64 by up to 0.02 in every f32 formulation, JAX's
    kernel's too.)"""
    radices, tw, window = K.mel_fft_plan(n_fft)
    assert np.prod(radices) == n_fft // 2 and tw.dtype == np.float32
    # the kernel's window is the plain version's: its bases' column 0
    np.testing.assert_array_equal(window, TA._dft_bases(n_fft)[0][:, 0])
    tone, noise = MEL_SIGNALS[signal]
    rng = np.random.default_rng(n_fft)
    t = np.arange(32000) / 16000.0
    audio = (tone * np.sin(2 * np.pi * 220.0 * t) + noise * rng.standard_normal(32000))[None]
    x = TA._padded_audio(torch.from_numpy(audio.astype(np.float32)), 16000, n_fft // 2)[0].numpy()
    n_frames = 48000 // TA.HOP_LENGTH
    idx = np.arange(n_frames)[:, None] * TA.HOP_LENGTH + np.arange(n_fft)[None, :]
    ours = _fft_plan_log10_mel(x[idx], n_fft, 128).T
    exact = _log10_mel_f64(x, 128, n_frames, n_fft)
    ref = np.asarray(log10_mel_pallas(jnp.asarray(x[idx]), 128, interpret=True)).T
    loud, above = exact >= exact.max() - 6.0, exact >= exact.max() - 8.0
    for other in (exact, ref):
        np.testing.assert_allclose(ours[loud], other[loud], rtol=0, atol=2e-4)
        np.testing.assert_allclose(ours[above], other[above], rtol=0, atol=1e-3)


@pytest.mark.parametrize("tone_hz", [6900.0, 500.0])
@pytest.mark.parametrize("n_fft", [400, 512])
def test_mel_refinement_holds_the_plain_limit(n_fft, tone_hz):
    """The FFT kernel's arithmetic with its refinement (emulated as above)
    against the plain version on 35 s of a 0.2 tone with 0.05 noise plus
    30 s of zeros, the kind of row chip_smoke.py's stack holds: the raw
    log10 within 2e-4 above each row's max - 8 floor and the normalized
    log-mel within 1e-4, the limits the card's kernel is held to. On such
    rows the spectral nulls sit where the f32 FFT and the DFT product round
    differently by more than the limit; the refined bins are the plain
    version's own sums."""
    rng = np.random.default_rng(int(tone_hz) + n_fft)
    t = np.arange(35 * 16000) / 16000.0
    audio = (0.2 * np.sin(2 * np.pi * tone_hz * t) + 0.05 * rng.standard_normal(t.shape))[None]
    x = TA._padded_audio(torch.from_numpy(audio.astype(np.float32)), TA.N_SAMPLES, n_fft // 2)
    consts = TA._front_end_constants(128, n_fft, torch.device("cpu"))
    plain = K.log10_mel_plain(x, *consts, TA.HOP_LENGTH)[0].numpy()
    n_frames = plain.shape[-1]
    idx = np.arange(n_frames)[:, None] * TA.HOP_LENGTH + np.arange(n_fft)[None, :]
    ours = _fft_plan_log10_mel(x[0].numpy()[idx], n_fft, 128).T
    above = plain >= plain.max() - 8.0
    np.testing.assert_allclose(ours[above], plain[above], rtol=0, atol=2e-4)
    floor = plain.max() - 8.0
    norm = lambda a: (np.maximum(a, floor) + 4.0) / 4.0  # noqa: E731
    np.testing.assert_allclose(norm(ours), norm(plain), rtol=0, atol=1e-4)


@pytest.mark.parametrize("pcm,padding", [(True, 480000), (False, 0)])
def test_log_mel_spectrogram_matches_jax(pcm, padding):
    """A stack of 3 rows, with and without whisper's 30 s of padding."""
    audio = _audio(5, 2.5, 3, pcm)
    for n_mels in (80, 128):
        ref = np.asarray(JA.log_mel_spectrogram(audio, n_mels=n_mels, padding=padding))
        ours = TA.log_mel_spectrogram(audio, n_mels=n_mels, padding=padding, device="cpu")
        assert ours.shape == ref.shape and ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-4)


def test_stacked_matmul_plain_matches_pallas():
    """JAX stacks the weights (L, K, N); the port (L, N, K), as its linears."""
    r = np.random.default_rng(2)
    L, Kd, N, B = 3, 256, 512, 24
    w = r.standard_normal((L, Kd, N)).astype(np.float32)
    x = r.standard_normal((B, Kd)).astype(np.float32)
    w_port = torch.from_numpy(np.ascontiguousarray(np.swapaxes(w, 1, 2)))
    for layer in range(L):
        ref = np.asarray(stacked_matmul_pallas(layer, jnp.asarray(x), jnp.asarray(w),
                                               interpret=True))
        ours = K.stacked_matmul_plain(torch.from_numpy(x), w_port, layer)
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-4)


def test_wrappers_take_the_plain_version_on_the_cpu():
    """For CPU tensors the wrappers return their plain versions and count no
    launch."""
    before = dict(K.LAUNCHES)
    x = torch.from_numpy(_audio(1, 0.5, 2, False))
    x = TA._padded_audio(x, 0, 200)
    consts = TA._front_end_constants(80, TA.N_FFT, torch.device("cpu"))
    assert torch.equal(K.log10_mel(x, *consts, 160), K.log10_mel_plain(x, *consts, 160))
    g = torch.Generator().manual_seed(0)
    xm, w = torch.randn((4, 64), generator=g), torch.randn((2, 32, 64), generator=g)
    assert torch.equal(K.stacked_matmul(xm, w, 1), K.stacked_matmul_plain(xm, w, 1))
    assert K.LAUNCHES == before
