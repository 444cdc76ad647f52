"""Speech2TextStreaming — the public streaming session API (port of
``speechcatcher_tpu/streaming.py``).

Raw-PCM chunks (or feature chunks) in; (text, tokens, token_ids, token_pos)
tuples out, with waveform buffering, STFT-boundary frame trimming, streaming
partials and a reset between utterances. The session runs on the model's
device; the card unless the model was built with device="cpu". On the card
each chunk's step (frontend, conv subsampling, encoder blocks) and each
block's beam loop run as CUDA graphs over the session's state, which stays
at fixed addresses between chunks and utterances (``decode.graphs``): one
graph per static signature, captured at first use, or ahead for a chunk
size by ``capture_graphs``. The host keeps the waveform buffer and every
length (``frontend_lengths``, ``models.encoder.plan_chunk``). On the CPU the
same programs run eagerly.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from speechcatcher_tpu_torch.decode.beam_search import (
    BlockwiseSynchronousBeamSearch,
)
from speechcatcher_tpu_torch.decode.graphs import ChunkInput, chunk_graph_keys
from speechcatcher_tpu_torch.device import resolve_device
from speechcatcher_tpu_torch.models.asr_model import ASRModel
from speechcatcher_tpu_torch.models.encoder import plan_chunk
from speechcatcher_tpu_torch.ops.layers import (
    cast_params,
    quantize_params_int8,
)

Result = Tuple[str, List[str], List[int], List[int]]


def frontend_lengths(win_length: int, hop_length: int,
                     n_buffer: Optional[int], n_new: int, is_final: bool
                     ) -> Tuple[Optional[int], int, int, Optional[int]]:
    """The session's waveform buffering and boundary trimming on lengths:
    a buffer of `n_buffer` samples (None before the first chunk) and
    `n_new` new ones → (samples the frontend processes, or None when it
    runs on nothing; frames cut at the start; frames cut at the end; the
    next buffer's length, None after a final). A final shorter than the
    window is zero-padded to it."""
    n = n_new + (n_buffer or 0)
    if n <= win_length:
        if not is_final:
            return None, 0, 0, n
        n = win_length
    if is_final:
        n_process, n_next = n, None
    else:
        overlap = win_length - hop_length
        n_frames, n_residual = divmod(n - overlap, hop_length)
        n_process = overlap + n_frames * hop_length
        n_next = overlap + n_residual
    trim = math.ceil(math.ceil(win_length / hop_length) / 2)
    t = 1 + n_process // hop_length
    if is_final:
        lo = trim if n_buffer is not None and t > trim else 0
        return n_process, lo, 0, n_next
    if n_buffer is None:
        return n_process, 0, trim if t > trim else 0, n_next
    if t > 2 * trim:
        return n_process, trim, trim, n_next
    return None, 0, 0, n_next


def assemble_hypothesis(cfg, tokenizer, yseq, xpos, is_final: bool
                        ) -> List[Result]:
    """Best-hypothesis output: strip SOS and the trailing EOS (final) or the
    unstable last token (partial), drop blank/unk/EOS, detokenize."""
    if len(yseq) <= 1:
        return []
    if is_final:
        token_ids = yseq[1:]
        pos = xpos[1:]
        if len(token_ids) > 0 and token_ids[-1] == cfg.eos_id:
            token_ids = token_ids[:-1]
            pos = pos[:-1]
    else:
        token_ids = yseq[1:-1]
        pos = xpos[1:-1]
    drop = {cfg.blank_id, tokenizer.unk_id, cfg.eos_id}
    keep = [i for i, tid in enumerate(token_ids) if int(tid) not in drop]
    token_ids = [int(token_ids[i]) for i in keep]
    token_pos = [int(pos[i]) for i in keep]
    tokens = tokenizer.ids_to_tokens(token_ids)
    text = "".join(tokens).replace("▁", " ").strip()
    return [(text, tokens, token_ids, token_pos)]


def chunk_signatures(cfg, chunk_samples: int) -> set:
    """The static signatures of every chunk program that a stream of
    `chunk_samples`-sample chunks can reach: from every state of its
    lengths that such chunks lead to, a next chunk and a final of every
    length from 1 to `chunk_samples` samples (``_infer_short`` finals
    included). Host arithmetic on lengths only."""
    win, hop = cfg.win_length, cfg.hop_length
    keys: set = set()

    def visit(state, n_new: int, is_final: bool):
        """Add a chunk's keys; the lengths' state after it."""
        n_buffer, n_before, n_after, npb = state
        n_process, lo, hi, n_next = frontend_lengths(
            win, hop, n_buffer, n_new, is_final)
        if n_process is None:
            return (n_next, n_before, n_after, npb)
        source = ChunkInput("wave", np.empty(n_process, np.float32), lo, hi)
        n_feats = source.n_frames(hop)
        if not BlockwiseSynchronousBeamSearch.encodes(n_feats, is_final):
            return (n_next, n_before, n_after, npb)
        plan = plan_chunk(cfg, n_before, n_feats, n_after, npb, is_final)
        keys.update(chunk_graph_keys(source.key(hop), plan))
        return (n_next, plan.n_before, plan.n_after, min(plan.npb, 1))

    # (waveform buffer length or None, feature frames carried, subsampled
    # frames carried, whether a block was processed)
    todo, seen = [(None, 0, 0, 0)], set()
    while todo:
        state = todo.pop()
        if state in seen:
            continue
        seen.add(state)
        # A final's programs depend on its frame count alone.
        finals = {}
        for n in range(1, chunk_samples + 1):
            total = n + (state[0] or 0)
            finals.setdefault(1 + max(total, win) // hop, n)
        for n in finals.values():
            visit(state, n, True)
        todo.append(visit(state, chunk_samples, False))
    return keys


class Speech2TextStreaming:
    """Streaming recognition session over one model.

    The session runs on ``device`` (the card by default; asking for CUDA
    where there is none raises). The model comes from ``model_dir``, an
    unpacked ESPnet model directory loaded onto that device, or is given as
    ``model``, which must lie on it.

    ``dtype`` is the precision mode. "float32" leaves the model as it is.
    "bfloat16" (and "float16", which maps to it) stores the matmul weights
    and the decoder's activation cache in bfloat16; "int8" further stores
    the encoder's linear weights as int8 with a per-channel scale, and
    "int8-all" every eligible linear's. These modes change the ``model``
    they are given: its ``params`` are replaced by the cast (and quantised)
    tree and its ``cfg`` gets ``cache_dtype="bfloat16"``.
    """

    DTYPES = ("float32", "float16", "bfloat16", "int8", "int8-all")

    def __init__(
        self,
        model_dir: Optional[Union[str, Path]] = None,
        beam_size: int = 5,
        ctc_weight: float = 0.3,
        device: Union[str, torch.device] = "cuda",
        dtype: str = "float32",
        use_bbd: bool = True,
        model: Optional[ASRModel] = None,
        penalty: float = 0.0,
        coverage_weight: float = 0.0,
    ):
        if dtype not in self.DTYPES:
            raise ValueError(f"dtype must be one of {self.DTYPES}, got "
                             f"{dtype!r}")
        dev = resolve_device(device)
        if model is None:
            if model_dir is None:
                raise ValueError("need model_dir or model")
            model = ASRModel.from_directory(Path(model_dir), device=dev)
        if model.device.type != dev.type:
            raise ValueError(f"model lies on {model.device}, session asked "
                             f"for {dev}")
        if dtype != "float32":
            model.params = cast_params(model.params)
            model.cfg = model.cfg.replace(cache_dtype="bfloat16")
            if dtype == "int8":
                model.params = quantize_params_int8(model.params)
            elif dtype == "int8-all":
                model.params = quantize_params_int8(model.params, scope=None)
        self.model = model
        self.cfg = model.cfg
        self.beam_size = beam_size
        self.ctc_weight = ctc_weight
        self.use_bbd = use_bbd
        self.tokenizer = model.tokenizer
        self.win_length = self.cfg.win_length
        self.hop_length = self.cfg.hop_length
        self.beam_search = BlockwiseSynchronousBeamSearch(
            model,
            beam_size=beam_size,
            ctc_weight=ctc_weight,
            use_bbd=use_bbd,
            penalty=penalty,
            coverage_weight=coverage_weight,
        )
        self.reset()

    def reset(self):
        """Reset all streaming state; the graphs and their buffers stay."""
        self.frontend_states: Optional[Dict] = None
        self.beam_search.reset()

    def _wave_input(self, speech: np.ndarray, prev_states: Optional[Dict],
                    is_final: bool
                    ) -> Tuple[Optional[ChunkInput], Optional[Dict]]:
        """Waveform buffering on the host (``frontend_lengths``): the
        samples the frontend processes with the frames to cut, or None,
        and the next states."""
        if prev_states is not None and "waveform_buffer" in prev_states:
            speech = np.concatenate([prev_states["waveform_buffer"], speech])
        n_buffer = None if prev_states is None else 0
        n_process, lo, hi, n_next = frontend_lengths(
            self.win_length, self.hop_length, n_buffer, speech.shape[0],
            is_final)
        if speech.shape[0] < self.win_length and is_final:
            pad = np.zeros(self.win_length - speech.shape[0],
                           dtype=speech.dtype)
            speech = np.concatenate([speech, pad])
        next_states = (None if n_next is None else
                       {"waveform_buffer":
                        speech[speech.shape[0] - n_next:].copy()})
        if n_process is None:
            return None, next_states
        return ChunkInput("wave", speech[:n_process], lo, hi), next_states

    def apply_frontend(self, speech: np.ndarray, prev_states: Optional[Dict],
                       is_final: bool
                       ) -> Tuple[Optional[torch.Tensor], Optional[Dict]]:
        """Waveform buffering + features + boundary trimming, eagerly.

        speech: (samples,) float32. Returns (feats (1, T, n_mels) | None,
        next_states)."""
        source, next_states = self._wave_input(speech, prev_states, is_final)
        if source is None:
            return None, next_states
        feats = self.model.frontend(source.data)
        return feats[:, source.lo:feats.shape[1] - source.hi], next_states

    def __call__(self, speech, is_final: bool = False,
                 finalize_all: bool = True,
                 always_assemble_hyps: bool = True) -> List[Result]:
        """Process one chunk: raw audio (samples,) or features
        (T, n_mels). Returns [(text, tokens, token_ids, token_pos)], where
        token_pos are encoder frame indices per token."""
        if not self.feed(speech, is_final):
            return []
        if not always_assemble_hyps and not is_final:
            return []
        results = self._assemble(is_final=is_final, finalize_all=finalize_all)
        if is_final:
            self.reset()
        return results

    def feed(self, speech, is_final: bool = False) -> bool:
        """Run one chunk through the frontend, the encoder and every beam
        block that is ready, without assembling a result or resetting after
        a final; False when the chunk only filled the waveform buffer."""
        if isinstance(speech, torch.Tensor):
            speech = speech.detach().cpu().numpy()
        speech = np.asarray(speech, dtype=np.float32)

        if speech.ndim == 1:
            source, self.frontend_states = self._wave_input(
                speech, self.frontend_states, is_final)
            if source is None:
                return False
        elif speech.ndim == 2:
            source = ChunkInput("features", speech)
        else:
            source = ChunkInput("normalized", torch.as_tensor(
                speech, device=self.model.device))
        self.beam_search.process_input(source, is_final=is_final)
        return True

    def graph_keys(self, chunk_samples: int) -> set:
        """The static signatures of every chunk program that a stream of
        `chunk_samples`-sample chunks can reach (``chunk_signatures``)."""
        return chunk_signatures(self.cfg, chunk_samples)

    def capture_graphs(self, chunk_samples: int) -> int:
        """Capture now every graph that decoding a stream of
        `chunk_samples`-sample chunks can reach (``graph_keys``, finals of
        every length included) and the block loop's graphs; decoding such
        a stream then captures nothing. Other chunk sizes are captured at
        first use. The counterpart of ``StreamingEngine.capture_graphs``;
        a no-op where the session runs eagerly. Returns the number of
        chunk signatures."""
        keys = self.graph_keys(chunk_samples)
        bs = self.beam_search
        if bs.chunk.graphed:
            bs.chunk.capture(sorted(keys, key=repr))
            bs.loop.settings = bs._settings()
            bs.loop.capture()
        return len(keys)

    def _assemble(self, is_final: bool, finalize_all: bool = True
                  ) -> List[Result]:
        """finalize_all=False on a final chunk emits only hypotheses that
        reached EOS."""
        yseq, xpos, _ = self.beam_search.best_hypothesis()
        if len(yseq) <= 1:
            return []
        if is_final and not finalize_all and int(yseq[-1]) != self.cfg.eos_id:
            return []
        return assemble_hypothesis(self.cfg, self.tokenizer, yseq, xpos,
                                   is_final=is_final)

    def recognize(self, speech) -> List[Result]:
        """Whole-utterance recognition."""
        self.reset()
        return self(speech, is_final=True)

    def recognize_stream(self, chunks) -> List[Result]:
        """Multi-chunk recognition over any iterable of chunks."""
        self.reset()
        chunks = list(chunks)
        results: List[Result] = []
        for i, chunk in enumerate(chunks):
            results = self(chunk, is_final=(i == len(chunks) - 1))
        return results

    @property
    def n_best_hypotheses(self) -> int:
        return self.beam_size


def create_streaming_interface(
    model_dir: Union[str, Path],
    beam_size: int = 5,
    ctc_weight: float = 0.3,
    device: Union[str, torch.device] = "cuda",
) -> Speech2TextStreaming:
    """A float32 session over the model directory, on the card by default."""
    return Speech2TextStreaming(
        model_dir=model_dir,
        beam_size=beam_size,
        ctc_weight=ctc_weight,
        device=device,
    )
