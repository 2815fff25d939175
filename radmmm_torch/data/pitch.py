"""Batched F0 and voicing extraction: YIN observations and pYIN with HMM
Viterbi smoothing, on the device of the audio.

Counterpart of ``radmmm_tpu/data/pitch.py`` (itself the batched stand-in
for the reference's per-utterance librosa.pyin): an FFT difference
function, cumulative-mean normalisation, a pYIN threshold sweep (beta
threshold prior, Boltzmann trough-rank prior) and a Viterbi pass over
(voiced, pitch bin) states with a triangular pitch-transition band and a
0.01 voicing switch probability. The static lag and bin tables are numpy.
The Viterbi DP and its backtrack are one hand-written CUDA kernel on the
card (``csrc/pyin_viterbi.cu``, counted as ``pyin_viterbi``); on the CPU
they are its plain twin ``viterbi_reference``, loops over frames in torch.
Both give the same paths bit for bit. Ties go to the first index, as
``jnp.argmax`` does.

The JAX package's divergences from librosa.pyin are kept: 20 thresholds
instead of 100, 5 pitch bins per semitone instead of 10.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from radmmm_torch.ops.stft import frame_signal
from radmmm_torch.utils import cuda_build
from radmmm_torch.utils.launches import launched


def _cmndf(audio: torch.Tensor, frame_length: int, hop_length: int):
    """Cumulative-mean-normalised difference function. Returns (cmndf
    (B, F, win), rms (B, F)) with win = frame_length // 2."""
    win = frame_length // 2
    frames = frame_signal(audio, frame_length, hop_length)   # (B, F, frame)
    # d(tau) = sum_j (x_j - x_{j+tau})^2 for j < win
    #        = e0 + e_tau - 2 corr(tau), the correlation by rFFT
    n_fft = 2 * frame_length
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    head_spec = torch.fft.rfft(frames[..., :win], n=n_fft, dim=-1)
    corr = torch.fft.irfft(spec * torch.conj(head_spec), n=n_fft,
                           dim=-1)[..., :win + 1]
    sq = frames ** 2
    csum = torch.cumsum(sq, dim=-1)
    e0 = csum[..., win - 1:win]                          # energy of x[0:win]
    e_tau = torch.cat([e0, csum[..., win:]
                       - csum[..., :frame_length - win]], dim=-1)
    d = torch.clamp_min(e0 + e_tau - 2.0 * corr, 0.0)    # (B, F, win + 1)
    tau = torch.arange(1, win + 1, dtype=torch.float32, device=audio.device)
    cmndf = d[..., 1:] * tau / torch.clamp_min(
        torch.cumsum(d[..., 1:], dim=-1), 1e-9)
    return cmndf, torch.sqrt(torch.mean(sq, dim=-1))


def _troughs(cmndf: torch.Tensor, in_range: torch.Tensor):
    """(cmndf outside the lag range set to inf, the local minima within
    it)."""
    cm_ranged = torch.where(in_range, cmndf, torch.inf)
    left = F.pad(cm_ranged, (1, 0), value=torch.inf)[..., :-1]
    right = F.pad(cm_ranged, (0, 1), value=torch.inf)[..., 1:]
    is_trough = (cm_ranged <= left) & (cm_ranged < right) & in_range
    return cm_ranged, is_trough


# constant tables, uploaded once a device and kept: a CUDA graph of the
# featurizer (``training/step.make_train_megastep``) cannot hold a copy
# from pageable host memory, and the eager path skips the upload
_tables: dict = {}


def _table(key: tuple, array: np.ndarray, dev) -> torch.Tensor:
    """``array`` on ``dev``, cached under ``key`` (the name and every
    parameter the array depends on)."""
    k = key + (str(dev),)
    t = _tables.get(k)
    if t is None:
        t = _tables[k] = torch.from_numpy(array).to(dev)
    return t


def yin_f0(audio: torch.Tensor, sampling_rate: int = 22050,
           frame_length: int = 1024, hop_length: int = 256,
           f0_min: float = 80.0, f0_max: float = 640.0):
    """audio (B, T) in [-1, 1] -> (f0, voiced_mask, p_voiced), each
    (B, 1 + T // hop_length): per-frame YIN picks, no smoothing."""
    win = frame_length // 2
    cmndf, rms = _cmndf(audio, frame_length, hop_length)
    dev = audio.device
    lag_min = max(sampling_rate / f0_max, 2.0)
    lag_max = min(sampling_rate / f0_min, float(win - 2))
    lags = torch.arange(1, win + 1, dtype=torch.float32, device=dev)
    cm_ranged, is_trough = _troughs(cmndf, (lags >= lag_min)
                                    & (lags <= lag_max))

    # p_voiced: the weighted share of thresholds with a trough below them
    thresholds = _table(("yin_thresholds",),
                        np.linspace(0.05, 1.0, 20).astype(np.float32), dev)
    trough_cm = torch.where(is_trough, cm_ranged, torch.inf)
    min_cm = torch.amin(trough_cm, dim=-1)
    weights = torch.exp(-2.0 * thresholds)           # favour strict ones
    below = (min_cm[..., None] < thresholds).float()
    p_voiced = (below * weights).sum(-1) / weights.sum()
    p_voiced = torch.where(rms > 1e-4, p_voiced, 0.0)  # silence: unvoiced
    voiced = p_voiced > 0.5

    # the first trough below 0.1, else the lowest trough
    below_t = trough_cm < 0.1
    first_below = torch.argmax(below_t.to(torch.int8), dim=-1)
    best = torch.where(below_t.any(dim=-1), first_below,
                       torch.argmin(trough_cm, dim=-1))
    # parabolic interpolation around the chosen lag on the raw cmndf
    idx = torch.clamp(best, 1, win - 2)

    def take(off):
        return torch.gather(cmndf, -1, (idx + off)[..., None])[..., 0]
    y0, y1, y2 = take(-1), take(0), take(1)
    denom = y0 - 2 * y1 + y2
    delta = torch.clamp(0.5 * (y0 - y2) / torch.where(
        denom.abs() < 1e-9, 1.0, denom), -0.5, 0.5)
    lag = (idx + 1).to(torch.float32) + delta
    f0 = sampling_rate / torch.clamp(lag, lag_min, lag_max)
    f0 = torch.where(voiced, f0, 0.0)
    return f0, voiced.to(torch.float32), p_voiced


def _beta_pmf(x: np.ndarray, a: float, b: float) -> np.ndarray:
    """Beta(a, b) density at x, normalised to a pmf (the threshold prior;
    librosa.pyin's beta_parameters=(2, 18))."""
    pdf = x ** (a - 1) * (1 - x) ** (b - 1)
    return pdf / pdf.sum()


def _first_score(log_obs: torch.Tensor) -> torch.Tensor:
    """The score of the first frame: a uniform prior over the 2 K states
    plus the first observation."""
    B, _, _, n_bins = log_obs.shape
    return (torch.log(torch.full((B, 2, n_bins), 1.0 / (2 * n_bins),
                                 device=log_obs.device)) + log_obs[:, 0])


def viterbi_reference(log_obs: torch.Tensor, log_P: torch.Tensor,
                      log_V: torch.Tensor):
    """Plain twin of the kernel (``viterbi``): a loop over frames keeps the
    back pointers, then one walks them back."""
    B, n_frames, _, n_bins = log_obs.shape
    dev = log_obs.device
    score = _first_score(log_obs)
    kptrs, vptrs = [], []
    for t in range(1, n_frames):
        # pitch move, then voicing flip (separable max-plus)
        m, kptr = torch.max(score[:, :, :, None] + log_P, dim=2)  # (B,2,K')
        c = m[:, None, :, :] + log_V.T[None, :, :, None]         # (B,2',2,K')
        new, vptr = torch.max(c, dim=2)
        new = new + log_obs[:, t]
        # renormalise against f32 drift over long files
        score = new - torch.amax(new, dim=(1, 2), keepdim=True)
        kptrs.append(kptr)
        vptrs.append(vptr)

    best = torch.argmax(score.reshape(B, -1), dim=-1)
    v, k = best // n_bins, best % n_bins
    bidx = torch.arange(B, device=dev)
    v_path, k_path = [v], [k]
    for t in range(n_frames - 2, -1, -1):
        v = vptrs[t][bidx, v, k]
        k = kptrs[t][bidx, v, k]
        v_path.append(v)
        k_path.append(k)
    return (torch.stack(v_path[::-1], dim=1),
            torch.stack(k_path[::-1], dim=1))


def viterbi(log_obs: torch.Tensor, log_P: torch.Tensor,
            log_V: torch.Tensor):
    """The pYIN HMM's best path: log_obs (B, F, 2, K) over (voiced,
    unvoiced) x pitch bin, log_P (K, K) pitch transitions, log_V (2, 2)
    voicing flips, all float32. Returns (voicing (B, F), 0 voiced; bin (B,
    F)), int64. CPU tensors run ``viterbi_reference``; CUDA tensors launch
    ``csrc/pyin_viterbi.cu`` (built by ``utils/cuda_build``) or raise."""
    B, n_frames, two, n_bins = log_obs.shape
    if (two != 2 or n_frames < 1 or log_P.shape != (n_bins, n_bins)
            or log_V.shape != (2, 2)):
        raise TypeError(f"viterbi: log_obs must be (B, F >= 1, 2, K), log_P "
                        f"(K, K), log_V (2, 2); got {tuple(log_obs.shape)}, "
                        f"{tuple(log_P.shape)}, {tuple(log_V.shape)}")
    for t in (log_obs, log_P, log_V):
        if t.dtype != torch.float32 or t.device != log_obs.device:
            raise TypeError(f"viterbi: every input must be float32 on "
                            f"{log_obs.device}, got {t.dtype} on {t.device}")
    if log_obs.device.type == "cpu":
        return viterbi_reference(log_obs, log_P, log_V)
    if log_obs.device.type != "cuda":
        raise RuntimeError(f"viterbi: no kernel for device {log_obs.device}")
    return _launch(log_obs.contiguous(), log_P.contiguous(),
                   log_V.contiguous())


def _launch(log_obs: torch.Tensor, log_P: torch.Tensor,
            log_V: torch.Tensor):
    """The kernel: the forward DP over every frame and the backtrack in one
    launch, a cluster of CTAs an item, with back pointers in a scratch of
    (B, F - 1, 2 K) int16."""
    B, n_frames, _, n_bins = log_obs.shape
    dev = log_obs.device
    v_path = torch.empty((B, n_frames), dtype=torch.int64, device=dev)
    k_path = torch.empty_like(v_path)
    if B == 0:
        return v_path, k_path
    lib = cuda_build.load("pyin_viterbi", _declare)
    most = lib.pyin_viterbi_max_bins()
    if n_bins > most:
        raise ValueError(f"viterbi: {n_bins} pitch bins do not fit the "
                         f"kernel's shared memory (at most {most} bins)")
    score0 = _first_score(log_obs)
    pred = torch.empty((B, max(n_frames - 1, 1), 2 * n_bins),
                       dtype=torch.int16, device=dev)
    with torch.cuda.device(dev):
        err = lib.pyin_viterbi_launch(
            score0.data_ptr(), log_obs.data_ptr(), log_P.data_ptr(),
            log_V.data_ptr(), pred.data_ptr(), v_path.data_ptr(),
            k_path.data_ptr(), B, n_frames, n_bins,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(lib, err, "pyin_viterbi")
    launched("pyin_viterbi")
    return v_path, k_path


def _declare(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.pyin_viterbi_launch.argtypes = [vp] * 7 + [ci] * 3 + [vp]
    lib.pyin_viterbi_launch.restype = ci
    lib.pyin_viterbi_max_bins.argtypes = []
    lib.pyin_viterbi_max_bins.restype = ci
    lib.pyin_viterbi_cluster.argtypes = [ci]
    lib.pyin_viterbi_cluster.restype = ci


def pyin_f0(audio: torch.Tensor, sampling_rate: int = 22050,
            frame_length: int = 1024, hop_length: int = 256,
            f0_min: float = 80.0, f0_max: float = 640.0,
            bins_per_semitone: int = 5, n_thresholds: int = 20,
            switch_prob: float = 0.01, boltzmann: float = 2.0,
            max_octaves_per_sec: float = 35.92):
    """pYIN with HMM Viterbi smoothing: audio (B, T) -> (f0, voiced_mask,
    p_voiced), each (B, 1 + T // hop_length). States are (voiced?, pitch
    bin): the pitch moves within a triangular band and the voicing flips
    with ``switch_prob``, which removes the octave jumps and the voicing
    flicker of per-frame picks."""
    win = frame_length // 2
    cmndf, rms = _cmndf(audio, frame_length, hop_length)
    dev = audio.device
    key = (sampling_rate, frame_length, hop_length, f0_min, f0_max,
           bins_per_semitone, n_thresholds, switch_prob, max_octaves_per_sec)

    # ---- static lag / pitch-bin tables (numpy) ----------------------------
    lags_np = np.arange(1, win + 1, dtype=np.float64)
    lag_min = max(sampling_rate / f0_max, 2.0)
    lag_max = min(sampling_rate / f0_min, float(win - 2))
    in_range_np = (lags_np >= lag_min) & (lags_np <= lag_max)
    n_bins = int(np.ceil(12 * bins_per_semitone
                         * np.log2(f0_max / f0_min))) + 1
    bin_freqs = f0_min * 2.0 ** (np.arange(n_bins)
                                 / (12.0 * bins_per_semitone))
    # lag -> nearest log-spaced bin, as a one-hot (win, n_bins) matrix
    f_of_lag = sampling_rate / lags_np
    bin_idx = np.clip(np.round(12 * bins_per_semitone
                               * np.log2(np.maximum(f_of_lag, 1e-6) / f0_min)
                               ).astype(np.int64), 0, n_bins - 1)
    assign = np.zeros((win, n_bins), np.float32)
    assign[np.arange(win), bin_idx] = in_range_np
    assign_t = _table(("assign",) + key, assign, dev)
    thresholds = np.linspace(0.0, 1.0, n_thresholds + 1)[1:]
    thr_prior = _table(("thr_prior",) + key, _beta_pmf(
        thresholds, 2.0, 18.0).astype(np.float32), dev)
    thr = _table(("thr",) + key, thresholds.astype(np.float32), dev)

    # ---- per-trough observation probabilities -----------------------------
    in_range = _table(("in_range",) + key, in_range_np, dev)
    cm_ranged, is_trough = _troughs(cmndf, in_range)
    # below[b, f, tau, i]: trough tau under threshold i; its rank is the
    # number of earlier troughs under the same threshold (the Boltzmann
    # prior prefers the first trough, the fundamental over subharmonics)
    bf = (is_trough[..., None] & (cm_ranged[..., None] < thr)).float()
    rank = torch.cumsum(bf, dim=2) - bf
    boltz = torch.exp(-boltzmann * rank) * bf
    norm = torch.clamp_min(boltz.sum(dim=2, keepdim=True), 1e-9)
    w = ((boltz / norm) * thr_prior).sum(-1)                    # (B, F, L)
    p_any = torch.clamp(w.sum(-1), 0.0, 1.0)
    sounding = rms > 1e-4
    p_voiced = torch.where(sounding, p_any, 0.0)
    w = w * sounding[..., None].float()

    # parabolic refinement of every lag, aggregated per pitch bin
    pad = F.pad(cmndf, (1, 1), mode="replicate")
    y0, y1, y2 = pad[..., :-2], cmndf, pad[..., 2:]
    denom = y0 - 2 * y1 + y2
    delta = torch.clamp(0.5 * (y0 - y2) / torch.where(
        denom.abs() < 1e-9, 1.0, denom), -0.5, 0.5)
    delta = torch.where(torch.isfinite(delta), delta, 0.0)
    lags = _table(("lags",) + key, lags_np.astype(np.float32), dev)
    f_interp = sampling_rate / torch.clamp(lags + delta, lag_min, lag_max)
    obs = torch.matmul(w, assign_t)                             # (B, F, K)
    f_num = torch.matmul(w * f_interp, assign_t)
    bin_f = _table(("bin_f",) + key, bin_freqs.astype(np.float32), dev)
    f_bin = torch.where(obs > 1e-9, f_num / torch.clamp_min(obs, 1e-9),
                        bin_f)

    # ---- HMM over (voiced, bin) and (unvoiced, bin) -----------------------
    log_obs_v = torch.log(obs + 1e-10)
    log_obs_u = torch.log(torch.clamp_min(
        (1.0 - p_any)[..., None] / n_bins, 1e-10)).expand(-1, -1, n_bins)
    log_obs = torch.stack([log_obs_v, log_obs_u], dim=2)       # (B, F, 2, K)

    width = max(1, int(round(max_octaves_per_sec * hop_length
                             / sampling_rate * 12 * bins_per_semitone)))
    offs = np.arange(-width, width + 1)
    tri = (width + 1 - np.abs(offs)).astype(np.float64)
    P = np.zeros((n_bins, n_bins))
    for o, t in zip(offs, tri):
        P += np.diag(np.full(n_bins - abs(o), t), k=int(o))
    P /= P.sum(axis=1, keepdims=True)
    log_P = _table(("log_P",) + key, np.log(P + 1e-12).astype(np.float32),
                   dev)
    log_V = _table(("log_V",) + key, np.log(np.array(
        [[1 - switch_prob, switch_prob],
         [switch_prob, 1 - switch_prob]])).astype(np.float32), dev)

    v_path, k_path = viterbi(log_obs, log_P, log_V)
    f0 = torch.gather(f_bin, -1, k_path[..., None])[..., 0]
    voiced = (v_path == 0) & sounding
    f0 = torch.where(voiced, f0, 0.0)
    return f0, voiced.to(torch.float32), p_voiced
