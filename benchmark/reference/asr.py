"""Plain reference of the streaming recognizer, for the check that decides
``correct``.

Plain PyTorch (float32) and NumPy (float64 for the CTC prefix scores), no
kernels, no graphs, no batching, one utterance at a time. It imports nothing
of the measured program: the weights are the benchmark's own tree, drawn in
the layout this module gives (``weight_specs``: the layer-stacked layout in
which the benchmark hands them to the program), and the audio is the
benchmark's own. A configuration that names no ``"reference"`` is checked
by this module; it defines the three names the harness takes from a
reference (``benchmark.harness.cell.REFERENCE_API``): ``Reference``,
``weight_specs`` and ``in_tf32``.

What it recomputes from the audio, its chunking and the weights:

- the streaming frontend: waveform buffering, reflect-padded STFT frames,
  power, Slaney mel, log, with the boundary frames trimmed as the session
  trims them (``stream_features``);
- the contextual block encoder, chunk by chunk: conv2d subsampling, blocks
  of ``block_size`` frames with their context vectors, the per-layer
  context carry between chunks, the emit windows, transformer or conformer
  layers (``StreamingEncoder``);
- the CTC head's log-probabilities over the emitted frames;
- for a served hypothesis (its tokens and the encoder position at which each
  was chosen), each token's decoder log-probability with the encoder frames
  visible when it was chosen, and each token's CTC prefix score with the
  streaming scorer's blank-extension of earlier prefixes (``rescore``).

``rescore`` returns the served hypothesis' total score by the beam search's
rule (``(1 - ctc_weight)`` times the decoder's log-probabilities plus
``ctc_weight`` times the CTC prefix score of the whole hypothesis) and, for
every token, how far its joint score lies below the ``beam``-th best joint
score of its prefix's candidates: a token the search chose has a parent whose
top ``beam`` expansions hold it.

The configuration is a dict (``benchmark/configs/<name>.json``'s ``model``).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-12
MASK_MIN = torch.finfo(torch.float32).min
LOGZERO = -1.0e10
TF32_DROP = 13          # float32 mantissa bits TF32 does not keep

# The control of the check: every product's operands rounded to TF32 (10
# mantissa bits, to nearest), as the card's TF32 mode rounds them. Off
# unless ``in_tf32`` is entered.
_ROUND = [False]


class in_tf32:
    """Within it, the reference rounds the operands of every matrix product
    and convolution to TF32: the control, one precision below float32."""

    def __enter__(self):
        _ROUND[0] = True

    def __exit__(self, *exc):
        _ROUND[0] = False


def _r(x: torch.Tensor) -> torch.Tensor:
    if not _ROUND[0]:
        return x
    bits = x.contiguous().view(torch.int32)
    half = 1 << (TF32_DROP - 1)
    mask = ~((1 << TF32_DROP) - 1)
    return ((bits + half) & mask).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _r(a) @ _r(b)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def weight_specs(m: Dict) -> Dict:
    """The layout of the weight tree this reference reads, with leaves ("u",
    shape, bound), ("n", shape), ("0", shape) or ("1", shape) for
    ``benchmark.harness.weights.make_tree`` to draw.

    It is the layout in which the program loads weights
    (``ASRModel.from_numpy``: nested dicts, the encoder's ``convs`` list,
    layer leaves stacked on a leading axis, torch-layout (out, in) linear
    weights), with the distributions of the program's own random
    initialisation: uniform ±1/sqrt(fan_in) weights, zero biases, unit
    LayerNorms, a standard-normal token embedding, Xavier-uniform position
    biases and identity BatchNorm statistics."""
    d, vocab = m["encoder_dim"], m["vocab_size"]

    def lin(d_in, d_out, lead=(), bias=True):
        p = {"weight": ("u", lead + (d_out, d_in), 1.0 / math.sqrt(d_in))}
        if bias:
            p["bias"] = ("0", lead + (d_out,))
        return p

    def norm(n, lead=()):
        return {"weight": ("1", lead + (n,)), "bias": ("0", lead + (n,))}

    def mha(lead):
        return {k: lin(d, d, lead) for k in ("linear_q", "linear_k",
                                              "linear_v", "linear_out")}

    def ffn(hidden, lead):
        return {"w_1": lin(d, hidden, lead), "w_2": lin(hidden, d, lead)}

    if m["input_layer"] != "conv2d":
        raise ValueError("the benchmark's weights know the conv2d input layer")
    f2 = ((m["n_mels"] - 3) // 2 + 1 - 3) // 2 + 1
    embed = {"convs": [
        {"weight": ("u", (d, 1, 3, 3), 1.0 / 3.0), "bias": ("0", (d,))},
        {"weight": ("u", (d, d, 3, 3), 1.0 / math.sqrt(d * 9)),
         "bias": ("0", (d,))}],
        "out": lin(d * f2, d)}
    el = (m["encoder_layers"],)
    if m["encoder_type"] == "conformer":
        h = m["encoder_heads"]
        dk = d // h
        attn = mha(el)
        attn["linear_pos"] = {"weight": ("u", el + (d, d),
                                         1.0 / math.sqrt(d))}
        xb = math.sqrt(6.0 / (h + dk))
        attn["pos_bias_u"] = ("u", el + (h, dk), xb)
        attn["pos_bias_v"] = ("u", el + (h, dk), xb)
        k = m["conformer_kernel_size"]
        conv = {
            "pointwise_conv1": {"weight": ("u", el + (2 * d, d, 1),
                                           1.0 / math.sqrt(d)),
                                "bias": ("0", el + (2 * d,))},
            "depthwise_conv": {"weight": ("u", el + (d, 1, k),
                                          1.0 / math.sqrt(k)),
                               "bias": ("0", el + (d,))},
            "batch_norm": {"weight": ("1", el + (d,)),
                           "bias": ("0", el + (d,)),
                           "running_mean": ("0", el + (d,)),
                           "running_var": ("1", el + (d,))},
            "pointwise_conv2": {"weight": ("u", el + (d, d, 1),
                                           1.0 / math.sqrt(d)),
                                "bias": ("0", el + (d,))},
        }
        layers = {"self_attn": attn,
                  "feed_forward": ffn(m["encoder_linear_units"], el),
                  "feed_forward_macaron": ffn(m["encoder_linear_units"], el),
                  "conv_module": conv,
                  **{n: norm(d, el) for n in ("norm_ff", "norm_ff_macaron",
                                              "norm_mha", "norm_conv",
                                              "norm_final")}}
    else:
        layers = {"self_attn": mha(el),
                  "feed_forward": ffn(m["encoder_linear_units"], el),
                  "norm1": norm(d, el), "norm2": norm(d, el)}
    dl = (m["decoder_layers"],)
    decoder = {"embed": {"weight": ("n", (vocab, d))},
               "layers": {"self_attn": mha(dl), "src_attn": mha(dl),
                          "feed_forward": ffn(m["decoder_linear_units"], dl),
                          "norm1": norm(d, dl), "norm2": norm(d, dl),
                          "norm3": norm(d, dl)},
               "after_norm": norm(d),
               "output_layer": lin(d, vocab)}
    return {"encoder": {"embed": embed, "layers": layers,
                        "after_norm": norm(d)},
            "decoder": decoder,
            "ctc": {"ctc_lo": lin(d, vocab)}}


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------

class Geometry(NamedTuple):
    vocab: int
    n_fft: int
    hop: int
    win: int
    n_mels: int
    sample_rate: int
    d: int
    heads: int
    layers: int
    block: int
    block_hop: int
    look_ahead: int
    conformer: bool
    dec_heads: int
    dec_layers: int
    ctc_weight: float
    pre_beam: int

    @property
    def eos(self) -> int:
        return self.vocab - 1

    @property
    def blank(self) -> int:
        return 0


def geometry(model: Dict) -> Geometry:
    return Geometry(
        vocab=model["vocab_size"], n_fft=model["n_fft"],
        hop=model["hop_length"], win=model["win_length"],
        n_mels=model["n_mels"], sample_rate=model["sample_rate"],
        d=model["encoder_dim"], heads=model["encoder_heads"],
        layers=model["encoder_layers"], block=model["block_size"],
        block_hop=model["hop_size"], look_ahead=model["look_ahead"],
        conformer=model["encoder_type"] == "conformer",
        dec_heads=model["decoder_heads"], dec_layers=model["decoder_layers"],
        ctc_weight=model["ctc_weight"], pre_beam=model["pre_beam_size"])


def pe_table(d: int, n: int, device) -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32)
                    * -(math.log(10000.0) / d))
    pe = torch.zeros((n, d), dtype=torch.float32)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(device)


# ---------------------------------------------------------------------------
# Frontend
# ---------------------------------------------------------------------------

def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3.0)
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0)
                    / (np.log(6.4) / 27.0), lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)),
                    m * 200.0 / 3.0)


def mel_matrix(g: Geometry) -> np.ndarray:
    """Slaney-scale, Slaney-normalised triangular filters (n_fft/2+1, mels)."""
    n_freqs = g.n_fft // 2 + 1
    freqs = np.linspace(0.0, g.sample_rate / 2.0, n_freqs)
    f_pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(g.sample_rate
                                                                / 2.0),
                                   g.n_mels + 2))
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - freqs[:, None]
    fb = np.maximum(0.0, np.minimum(-slopes[:, :-2] / f_diff[:-1],
                                    slopes[:, 2:] / f_diff[1:]))
    fb = fb * (2.0 / (f_pts[2:] - f_pts[:-2]))[None, :]
    return fb.astype(np.float32)


class Frontend:
    def __init__(self, g: Geometry, device):
        self.g = g
        n = np.arange(g.win, dtype=np.float64)
        hann = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / g.win))
        window = np.zeros(g.n_fft, np.float32)
        left = (g.n_fft - g.win) // 2
        window[left:left + g.win] = hann
        self.window = torch.from_numpy(window).to(device)
        self.mel = torch.from_numpy(mel_matrix(g)).to(device)
        self.device = device

    def __call__(self, wave: np.ndarray) -> torch.Tensor:
        """(samples,) → (frames, mels): centred, reflect-padded frames."""
        g = self.g
        x = torch.from_numpy(np.ascontiguousarray(wave, np.float32)).to(
            self.device)
        pad = g.n_fft // 2
        x = F.pad(x[None, None], (pad, pad), mode="reflect")[0, 0]
        frames = x.unfold(0, g.n_fft, g.hop) * self.window
        spec = torch.fft.rfft(frames, n=g.n_fft, dim=-1)
        power = spec.real.square() + spec.imag.square()
        return torch.log(torch.clamp(_mm(power, self.mel), min=1e-10))


def stream_features(g: Geometry, frontend: Frontend,
                    chunks: Sequence[np.ndarray]) -> List[torch.Tensor]:
    """Feature frames of each chunk as the streaming session makes them
    (the last chunk is the final one): a waveform buffer of the samples not
    yet framed, and ``trim`` frames cut where a chunk's edge reflects."""
    trim = math.ceil(math.ceil(g.win / g.hop) / 2)
    overlap = g.win - g.hop
    buffer: Optional[np.ndarray] = None
    out = []
    for i, chunk in enumerate(chunks):
        final = i == len(chunks) - 1
        first = buffer is None
        speech = chunk if first else np.concatenate([buffer, chunk])
        n = len(speech)
        if n <= g.win and not final:
            buffer = speech
            out.append(None)
            continue
        if final:
            if n < g.win:
                speech = np.concatenate([speech, np.zeros(g.win - n,
                                                          np.float32)])
            n_process = max(n, g.win)
        else:
            n_frames, residual = divmod(n - overlap, g.hop)
            n_process = overlap + n_frames * g.hop
            buffer = speech[n - (overlap + residual):]
        t = 1 + n_process // g.hop
        if final:
            lo, hi = (trim if not first and t > trim else 0), 0
        elif first:
            lo, hi = 0, (trim if t > trim else 0)
        elif t > 2 * trim:
            lo, hi = trim, trim
        else:
            out.append(None)
            continue
        feats = frontend(speech[:n_process])
        feats = feats[lo:feats.shape[0] - hi]
        # A non-final chunk of fewer than 3 frames is not encoded.
        out.append(feats if (final or feats.shape[0] >= 3) else None)
    return out


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _ln(p, i, x, eps=LN_EPS):
    w = p["weight"] if i is None else p["weight"][i]
    b = p["bias"] if i is None else p["bias"][i]
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def _lin(p, i, x):
    w = p["weight"] if i is None else p["weight"][i]
    y = _mm(x, w.t())
    if "bias" in p:
        y = y + (p["bias"] if i is None else p["bias"][i])
    return y


def _ffn(p, i, x):
    return _lin(p["w_2"], i, torch.relu(_lin(p["w_1"], i, x)))


def _heads(x, h):
    b, t, d = x.shape
    return x.reshape(b, t, h, d // h).transpose(1, 2)


def _softmax_masked(scores, keep):
    if keep is None:
        return torch.softmax(scores, dim=-1)
    scores = torch.where(keep, scores, MASK_MIN)
    return torch.where(keep, torch.softmax(scores, dim=-1), 0.0)


def _mha(p, i, q_in, kv_in, keep, h):
    q = _heads(_lin(p["linear_q"], i, q_in), h)
    k = _heads(_lin(p["linear_k"], i, kv_in), h)
    v = _heads(_lin(p["linear_v"], i, kv_in), h)
    scores = _mm(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    x = _mm(_softmax_masked(scores, keep), v)
    b, _, t, dk = x.shape
    return _lin(p["linear_out"], i, x.transpose(1, 2).reshape(b, t, h * dk))


def _rel_shift(x):
    b, h, tq, tk = x.shape
    padded = torch.cat([x.new_zeros((b, h, tq, 1)), x], dim=-1)
    return padded.reshape(b, h, tk + 1, tq)[:, :, 1:].reshape(b, h, tq, tk)


def _rel_mha(p, i, x, pos_emb, keep, h):
    q = _heads(_lin(p["linear_q"], i, x), h)
    k = _heads(_lin(p["linear_k"], i, x), h)
    v = _heads(_lin(p["linear_v"], i, x), h)
    pos = _heads(_mm(pos_emb, p["linear_pos"]["weight"][i].t()), h)
    dk = q.shape[-1]
    ac = _mm(q + p["pos_bias_u"][i][None, :, None, :], k.transpose(-1, -2))
    bd = _rel_shift(_mm(q + p["pos_bias_v"][i][None, :, None, :],
                        pos.transpose(-1, -2)))
    out = _mm(_softmax_masked((ac + bd) / math.sqrt(dk), keep), v)
    b, _, t, _ = out.shape
    return _lin(p["linear_out"], i, out.transpose(1, 2).reshape(b, t, h * dk))


def _conv_module(p, i, x):
    w1 = p["pointwise_conv1"]["weight"][i][:, :, 0]
    hid = _mm(x, w1.t()) + p["pointwise_conv1"]["bias"][i]
    a, b = hid.chunk(2, dim=-1)
    hid = a * torch.sigmoid(b)
    dw = p["depthwise_conv"]["weight"][i]
    hid = F.conv1d(_r(hid.transpose(1, 2)), _r(dw),
                   p["depthwise_conv"]["bias"][i],
                   padding=(dw.shape[-1] - 1) // 2,
                   groups=dw.shape[0]).transpose(1, 2)
    bn = p["batch_norm"]
    hid = ((hid - bn["running_mean"][i])
           * torch.rsqrt(bn["running_var"][i] + 1e-5) * bn["weight"][i]
           + bn["bias"][i])
    hid = hid * torch.sigmoid(hid)
    w2 = p["pointwise_conv2"]["weight"][i][:, :, 0]
    return _mm(hid, w2.t()) + p["pointwise_conv2"]["bias"][i]


def encoder_layer(g: Geometry, p, i, x, keep, pos_emb):
    """One pre-norm transformer layer, or one macaron conformer layer."""
    if not g.conformer:
        hn = _ln(p["norm1"], i, x)
        x = x + _mha(p["self_attn"], i, hn, hn, keep, g.heads)
        return x + _ffn(p["feed_forward"], i, _ln(p["norm2"], i, x))
    x = x + 0.5 * _ffn(p["feed_forward_macaron"], i,
                       _ln(p["norm_ff_macaron"], i, x))
    x = x + _rel_mha(p["self_attn"], i, _ln(p["norm_mha"], i, x), pos_emb,
                     keep, g.heads)
    x = x + _conv_module(p["conv_module"], i, _ln(p["norm_conv"], i, x))
    x = x + 0.5 * _ffn(p["feed_forward"], i, _ln(p["norm_ff"], i, x))
    return _ln(p["norm_final"], i, x)


def subsample(p, x):
    """(T, mels) → (T', d): two 3×3 stride-2 convolutions, ReLU, linear."""
    h = x[None, None]
    for conv in p["convs"]:
        h = torch.relu(F.conv2d(_r(h), _r(conv["weight"]), conv["bias"],
                                stride=2))
    _, c, t, f = h.shape
    return _lin(p["out"], None, h[0].transpose(0, 1).reshape(t, c * f))


def sub_len(n: int) -> int:
    for _ in range(2):
        n = (n - 3) // 2 + 1
    return n


class StreamingEncoder:
    """The contextual block encoder over one stream's feature chunks."""

    def __init__(self, g: Geometry, p, device):
        self.g, self.p = g, p
        self.pe = pe_table(g.d, 5000, device)
        w = g.block + 2
        mask = torch.zeros((w, w), dtype=torch.bool, device=device)
        mask[1:, :g.block + 1] = True
        self.keep = mask
        self.device = device

    def _pe(self, x, offset):
        t = x.shape[-2]
        start = max(0, min(int(offset), self.pe.shape[0] - t))
        return x * math.sqrt(x.shape[-1]) + self.pe[start:start + t]

    def run(self, feats: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
        """Emitted frames (T, d) of a stream whose last chunk is final."""
        g = self.g
        bs, hop, la = g.block, g.block_hop, g.look_ahead
        buf_before = None
        buf_after = None
        prev_addin = None
        past_ctx = None
        npb = 0
        out = []
        for i, x in enumerate(feats):
            final = i == len(feats) - 1
            if x is None:
                continue
            if buf_before is not None:
                x = torch.cat([buf_before, x])
            n_in = x.shape[0]
            n_conv = n_in
            if not final:
                n_samples = n_in // 4 - 1
                if n_samples < 2:
                    buf_before = x
                    continue
                keep_before = n_in % 4 + 8
                n_conv = n_samples * 4
                buf_before = x[n_in - keep_before:]
            n_sub = max(sub_len(n_conv), 0)
            xs = (subsample(self.p["embed"], x[:n_conv]) if n_sub > 0
                  else x.new_zeros((0, g.d)))
            if buf_after is not None:
                xs = torch.cat([buf_after, xs])
            total = xs.shape[0]
            first = npb == 0
            if final:
                if total == 0:
                    break
                block_num = math.ceil((total - (bs - hop - la) - la) / hop)
                n_blocks_in = total
            else:
                if total <= bs:
                    buf_after = xs
                    continue
                block_num = max(0, total - (bs - hop)) // hop
                buf_after = xs[hop * block_num:]
                n_blocks_in = block_num * hop + bs - hop
            xs = xs[:n_blocks_in]
            if first and final and total <= bs:
                out.append(self._short(xs))
                break
            block_num = max(block_num, 1)
            offset = bs - la - hop
            if final:
                y_len = n_blocks_in if first else n_blocks_in - offset
            else:
                y_len = block_num * hop + (offset if first else 0)
            ys, prev_addin, past_ctx = self._blocks(
                xs, prev_addin, past_ctx, npb, total, block_num, first,
                final, y_len)
            out.append(ys)
            npb += block_num
        return torch.cat(out) if out else torch.zeros((0, g.d),
                                                      device=self.device)

    def _layers(self, x, keep, pos_emb, ctx_fn):
        for i in range(self.g.layers):
            x = encoder_layer(self.g, self.p["layers"], i, x, keep, pos_emb)
            ctx_fn(i, x)
        return x

    def _short(self, xs):
        g = self.g
        x = self._pe(xs, 0)[None]
        x = self._layers(x, None, self.pe[None, :xs.shape[0]],
                         lambda i, x: None)
        return _ln(self.p["after_norm"], None, x[0])

    def _blocks(self, xs, prev_addin, past_ctx, npb, total, block_num,
                first, final, y_len):
        g = self.g
        bs, hop, la = g.block, g.block_hop, g.look_ahead
        blocks, addins = [], []
        for i in range(block_num):
            cl = min(bs, total - i * hop)
            data = xs[i * hop:i * hop + cl]
            addins.append(self._pe(data.mean(dim=0, keepdim=True), npb + i))
            chunk = self._pe(data, i * hop + hop * npb)
            blocks.append(F.pad(chunk, (0, 0, 0, bs - cl)))
        prev = [prev_addin if prev_addin is not None else addins[0]]
        prev += addins[:-1]
        x = torch.stack([torch.cat([prev[i], blocks[i], addins[i]])
                         for i in range(block_num)])      # (bn, bs+2, d)
        ctx = []

        def carry(i, x):
            first_ctx = past_ctx[i] if past_ctx is not None else x[0, -1]
            x[:, 0] = torch.cat([first_ctx[None], x[:-1, -1]])
            ctx.append(x[-1, -1].clone())

        x = self._layers(x, self.keep, self.pe[None, :bs + 2], carry)
        x = x[:, 1:bs + 1]
        offset = bs - la - hop
        pieces, emitted = [], 0
        if first:
            pieces.append(x[0, :offset])
            emitted = offset
        for i in range(block_num):
            cl = min(bs - offset, y_len - emitted) if (
                i == block_num - 1 and final) else hop
            cl = max(cl, 0)
            if cl:
                pieces.append(x[i, offset:offset + cl])
                emitted += cl
        ys = torch.cat(pieces)
        if ys.shape[0] != y_len:
            raise RuntimeError(f"emitted {ys.shape[0]} frames, expected "
                               f"{y_len}")
        return _ln(self.p["after_norm"], None, ys), addins[-1], torch.stack(ctx)


# ---------------------------------------------------------------------------
# Decoder and CTC prefix scores of a served hypothesis
# ---------------------------------------------------------------------------

class Rescored(NamedTuple):
    score: float            # the served hypothesis' total score
    token_gaps: np.ndarray  # per token: beam-th best joint score minus its own


def _lse(a: float, b: float) -> float:
    if a < b:
        a, b = b, a
    return a + math.log1p(math.exp(b - a)) if b > -1e300 else a


class CTCPrefix:
    """Forward variables of one prefix: exact over [0, end), blank-extended
    beyond ``end`` (the streaming scorer extends a prefix that was scored
    earlier through blanks alone)."""

    def __init__(self, x: np.ndarray, blank: int):
        self.x = x                      # (T, V) float64 log-probs
        self.xb = x[:, blank]
        self.cxb = np.concatenate([[0.0], np.cumsum(self.xb)])

    def root(self):
        t = self.x.shape[0]
        rn = np.full(t, LOGZERO)
        rb = self.cxb[1:].copy()        # all blanks from frame 0
        return rn, rb, t                # exact everywhere

    def extended(self, r, upto: int):
        """(rn, rb) over [0, upto), blank-extended from r's end."""
        rn, rb, end = r
        if upto <= end:
            return rn[:upto], rb[:upto]
        base = rb[end - 1] if end > 0 else 0.0
        ext_b = base + (self.cxb[end + 1:upto + 1] - self.cxb[end])
        return (np.concatenate([rn[:end], np.full(upto - end, LOGZERO)]),
                np.concatenate([rb[:end], ext_b]))

    def psi(self, rn, rb, c: int, last: int, olen: int, end: int,
            eos: int) -> float:
        """log psi of the prefix extended by c over frames [0, end)."""
        if c == eos:
            return _lse(rn[end - 1], rb[end - 1])
        phi = rb if c == last else np.logaddexp(rn, rb)
        start = min(max(olen, 1), end)
        terms = phi[start - 1:end - 1] + self.x[start:end, c]
        parts = [terms] if len(terms) else []
        if olen == 0:
            parts.append(np.array([self.x[0, c]]))
        if not parts:
            return LOGZERO
        allt = np.concatenate(parts)
        m = allt.max()
        return float(m + np.log(np.exp(allt - m).sum()))

    def psi_many(self, rn, rb, cands: np.ndarray, last: int, olen: int,
                 end: int) -> np.ndarray:
        """psi for many non-EOS candidates at once."""
        start = min(max(olen, 1), end)
        lse_r = np.logaddexp(rn, rb)
        out = np.empty(len(cands))
        for k, c in enumerate(cands):
            phi = rb if c == last else lse_r
            terms = phi[start - 1:end - 1] + self.x[start:end, c]
            if olen == 0:
                terms = np.concatenate([terms, [self.x[0, c]]])
            if len(terms) == 0:
                out[k] = LOGZERO
                continue
            m = terms.max()
            out[k] = m + np.log(np.exp(terms - m).sum())
        return out

    def advance(self, r, c: int, last: int, olen: int, end: int):
        """Forward variables of the prefix extended by c, exact over
        [0, end)."""
        rn_p, rb_p = self.extended(r, end)
        phi = rb_p if c == last else np.logaddexp(rn_p, rb_p)
        rn = np.full(end, LOGZERO)
        rb = np.full(end, LOGZERO)
        if olen == 0 and end > 0:
            rn[0] = self.x[0, c]
        start = min(max(olen, 1), end)
        xc = self.x[:, c]
        n_prev = rn[start - 1] if start > 0 else LOGZERO
        b_prev = rb[start - 1] if start > 0 else LOGZERO
        for t in range(start, end):
            n_t = _lse(n_prev, phi[t - 1]) + xc[t]
            b_t = _lse(n_prev, b_prev) + self.xb[t]
            rn[t], rb[t] = n_t, b_t
            n_prev, b_prev = n_t, b_t
        return rn, rb, end


class Reference:
    """The reference model: weights (the benchmark's tree on one device),
    the configuration's geometry."""

    def __init__(self, model_cfg: Dict, tree, device):
        self.g = geometry(model_cfg)
        self.tree = tree
        self.device = device
        self.frontend = Frontend(self.g, device)
        self.encoder = StreamingEncoder(self.g, tree["encoder"], device)
        self.dec_pe = pe_table(self.g.d, 5000, device)

    @torch.no_grad()
    def encode(self, chunks: Sequence[np.ndarray]) -> torch.Tensor:
        feats = stream_features(self.g, self.frontend, chunks)
        return self.encoder.run(feats)

    @torch.no_grad()
    def ctc_logp(self, enc: torch.Tensor) -> np.ndarray:
        logits = _lin(self.tree["ctc"]["ctc_lo"], None, enc)
        return torch.log_softmax(logits, dim=-1).double().cpu().numpy()

    @torch.no_grad()
    def rescore(self, enc: torch.Tensor, x_ctc: np.ndarray,
                yseq: Sequence[int], xpos: Sequence[int],
                beam: int) -> Rescored:
        g = self.g
        p = self.tree["decoder"]
        d = g.d
        layers = g.dec_layers
        pl = p["layers"]
        mem_k = [_heads(_lin(pl["src_attn"]["linear_k"], i, enc[None]),
                        g.dec_heads) for i in range(layers)]
        mem_v = [_heads(_lin(pl["src_attn"]["linear_v"], i, enc[None]),
                        g.dec_heads) for i in range(layers)]
        cache: List[List[torch.Tensor]] = [[] for _ in range(layers)]
        ctc = CTCPrefix(x_ctc, g.blank)
        r = ctc.root()
        psi_prev = 0.0
        w = g.ctc_weight
        total_dec = 0.0
        gaps = []
        for j in range(1, len(yseq)):
            tok, last = int(yseq[j]), int(yseq[j - 1])
            vis = int(xpos[j]) + 1
            pos = j - 1
            h = p["embed"]["weight"][last][None, None] * math.sqrt(d) \
                + self.dec_pe[pos][None, None]
            for i in range(layers):
                hn = _ln(pl["norm1"], i, h)
                cache[i].append(hn)
                hist = torch.cat(cache[i], dim=1)
                h = h + _mha(pl["self_attn"], i, hn, hist, None, g.dec_heads)
                hn = _ln(pl["norm2"], i, h)
                q = _heads(_lin(pl["src_attn"]["linear_q"], i, hn),
                           g.dec_heads)
                att = torch.softmax(
                    _mm(q, mem_k[i][:, :, :vis].transpose(-1, -2))
                    / math.sqrt(q.shape[-1]), dim=-1)
                att = _mm(att, mem_v[i][:, :, :vis]).transpose(1, 2).reshape(
                    1, 1, d)
                h = h + _lin(pl["src_attn"]["linear_out"], i, att)
                h = h + _ffn(pl["feed_forward"], i, _ln(pl["norm3"], i, h))
            h = _ln(p["after_norm"], None, h)
            dec = torch.log_softmax(_lin(p["output_layer"], None, h)[0, 0],
                                    dim=-1).double().cpu().numpy()
            # Candidates: the pre-beam by decoder score (stable, lower id on
            # ties), EOS (always scored) and the served token; not blank.
            order = np.argsort(-dec, kind="stable")[:min(g.pre_beam, g.vocab)]
            cands = np.unique(np.concatenate([order, [g.eos, tok]]))
            cands = cands[cands != g.blank]
            olen = j - 1
            rn, rb = ctc.extended(r, vis)
            non_eos = cands[cands != g.eos]
            psi = dict(zip(non_eos.tolist(),
                           ctc.psi_many(rn, rb, non_eos, last, olen,
                                        vis).tolist()))
            psi[g.eos] = ctc.psi(rn, rb, g.eos, last, olen, vis, g.eos)
            joint = np.array([(1.0 - w) * dec[c] + w * (psi[c] - psi_prev)
                              for c in cands.tolist()])
            own = (1.0 - w) * dec[tok] + w * (psi[tok] - psi_prev)
            thr = np.sort(joint)[::-1][min(beam, len(joint)) - 1]
            gaps.append(max(0.0, float(thr - own)))
            total_dec += float(dec[tok])
            # The scorer advances a hypothesis by its token's column; one
            # that ends in an EOS outside the pre-beam takes the first
            # candidate's (the search may go on from a committed EOS).
            col = tok if (tok != g.eos or g.eos in order) else int(order[0])
            r = ctc.advance(r, col, last, olen, vis)
            psi_prev = psi[tok]
        score = (1.0 - w) * total_dec + w * psi_prev
        return Rescored(float(score), np.asarray(gaps, np.float64))
