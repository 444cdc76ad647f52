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
length (``geometry``). On the CPU the same programs run eagerly.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from speechcatcher_tpu_torch import geometry
from speechcatcher_tpu_torch.decode.beam_search import (
    BlockwiseSynchronousBeamSearch,
)
from speechcatcher_tpu_torch.decode.graphs import ChunkInput, chunk_graph_keys
from speechcatcher_tpu_torch.device import resolve_device
from speechcatcher_tpu_torch.models.asr_model import ASRModel
from speechcatcher_tpu_torch.ops.layers import (
    cast_params,
    quantize_params_int8,
)

Result = Tuple[str, List[str], List[int], List[int]]


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
    included). Host arithmetic on lengths only (``geometry``)."""
    keys: set = set()

    def add(n_process, lo, hi, plan):
        keys.update(chunk_graph_keys(
            ("frontend", int(geometry.stft_frames(cfg, n_process)), int(lo),
             int(hi)), plan))

    # (waveform buffer length or None, feature frames carried, subsampled
    # frames carried, whether a block was processed)
    todo, seen = [(None, 0, 0, 0)], set()
    while todo:
        state = todo.pop()
        if state in seen:
            continue
        seen.add(state)
        n_buffer, n_before, n_after, npb = state
        first = n_buffer is None
        # Every final length at once; its programs depend on its frame
        # count alone.
        fin = geometry.plan_frontend(
            cfg, n_buffer or 0, np.arange(1, chunk_samples + 1), first, True)
        _, at = np.unique(fin.n_process // cfg.hop_length, return_index=True)
        for i, plan in zip(at, geometry.plan_chunks(
                cfg, n_before, fin.n_frames[at], n_after, npb, True)):
            add(fin.n_process[i], fin.lo, 0, plan)
        fe = geometry.plan_frontend(cfg, n_buffer or 0, chunk_samples, first,
                                    False)
        nxt = (int(fe.n_keep), n_before, n_after, npb)
        if BlockwiseSynchronousBeamSearch.encodes(int(fe.n_frames), False):
            plan = geometry.plan_chunk(cfg, n_before, int(fe.n_frames),
                                       n_after, npb, False)
            add(fe.n_process, fe.lo, fe.hi, plan)
            nxt = (int(fe.n_keep), plan.n_before, plan.n_after,
                   min(plan.npb, 1))
        todo.append(nxt)
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
    tree and its ``cfg`` gets ``cache_dtype="bfloat16"``. A model with a
    fused LM runs in "float32" alone; ``lm_weight`` weighs the LM, the
    model configuration's unless given.
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
        lm_weight: Optional[float] = None,
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
            if model.cfg.lm_layers:
                raise ValueError(f"dtype {dtype!r}: a model with a fused LM "
                                 f"runs in float32 alone")
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
            lm_weight=lm_weight,
        )
        self.reset()

    def reset(self):
        """Reset all streaming state; the graphs and their buffers stay."""
        self.frontend_states: Optional[Dict] = None
        self.beam_search.reset()

    def _wave_input(self, speech: np.ndarray, prev_states: Optional[Dict],
                    is_final: bool
                    ) -> Tuple[Optional[ChunkInput], Optional[Dict]]:
        """Waveform buffering on the host (``geometry.plan_frontend``): the
        samples the frontend processes with the frames to cut, or None,
        and the next states."""
        if prev_states is not None and "waveform_buffer" in prev_states:
            speech = np.concatenate([prev_states["waveform_buffer"], speech])
        fe = geometry.plan_frontend(self.cfg, 0, speech.shape[0],
                                    prev_states is None, is_final)
        if fe.pad:
            speech = np.concatenate([speech, np.zeros(int(fe.pad),
                                                      speech.dtype)])
        next_states = (None if is_final else
                       {"waveform_buffer": speech[int(fe.keep_from):].copy()})
        if not fe.n_frames:
            return None, next_states
        return (ChunkInput("wave", speech[:int(fe.n_process)], int(fe.lo),
                           int(fe.hi)), next_states)

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
