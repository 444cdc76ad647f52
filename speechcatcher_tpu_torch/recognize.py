"""Batch/file/microphone recognition pipeline + CLI (port of
``speechcatcher_tpu/recognize.py``).

Model-tag registry, ``load_model``, media-file decoding with energy
segmentation, paragraph merging with sentence-completion checks, token
timestamps, .txt/.json output, and live microphone transcription with
plateau endpointing. Everything runs on the card unless the caller asks for
the CPU (``device="cpu"``, ``--device cpu``).

- Segment parallelism: ``num_processes > 1`` decodes a file's segments as
  streams of one batched ``StreamingEngine`` (one weight copy on one card)
  with output identical to the serial path.
- Timestamps: token positions are exact encoder frame indices, converted by
  the true frame duration (subsample·hop/rate = 40 ms).
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import sys
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from speechcatcher_tpu_torch.endpointing import segment_speech
from speechcatcher_tpu_torch.streaming import Speech2TextStreaming
from speechcatcher_tpu_torch.utils.audio import convert_media

logger = logging.getLogger(__name__)

# Model-tag registry: tag → HuggingFace repo id.
tags = {
    "de_streaming_transformer_m": "speechcatcher/speechcatcher_german_espnet_streaming_transformer_13k_train_size_m_raw_de_bpe1024",
    "de_streaming_transformer_l": "speechcatcher/speechcatcher_german_espnet_streaming_transformer_13k_train_size_l_raw_de_bpe1024",
    "de_streaming_transformer_xl": "speechcatcher/speechcatcher_german_espnet_streaming_transformer_26k_train_size_xl_raw_de_bpe1024",
    "es_streaming_transformer_m": "speechcatcher/wordcab_speechcatcher_spanish_espnet_streaming_transformer_35k_train_size_m_raw_es_bpe1024",
    "es_streaming_transformer_l": "speechcatcher/wordcab_speechcatcher_spanish_espnet_streaming_transformer_35k_train_size_l_raw_es_bpe1024",
    "en_streaming_transformer_m": "speechcatcher/wordcab_speechcatcher_english_espnet_streaming_transformer_35k_train_size_m_raw_en_bpe1024",
    "en_streaming_transformer_l": "speechcatcher/wordcab_speechcatcher_english_espnet_streaming_transformer_35k_train_size_l_raw_en_bpe1024",
}


def load_model(
    tag: str,
    device: str = "cuda",
    beam_size: int = 5,
    quiet: bool = False,
    cache_dir: str = "~/.cache/speechcatcher_tpu",
    fp16: bool = False,
    use_bbd: bool = True,
    dtype: Optional[str] = None,
) -> Speech2TextStreaming:
    """Resolve a tag/path/URL to a ready streaming session on `device`.

    `dtype` is the session's precision mode (float32 | bfloat16 | int8 |
    int8-all); without it `fp16` selects bfloat16, else float32."""
    from speechcatcher_tpu_torch.utils.zoo import download_and_unpack

    resolved = tags.get(tag, tag)
    model_dir = download_and_unpack(resolved,
                                    cache_dir=Path(cache_dir).expanduser(),
                                    quiet=quiet)
    if not quiet:
        print(f"Loading model from {model_dir}")
    return Speech2TextStreaming(
        model_dir=model_dir,
        beam_size=beam_size,
        ctc_weight=0.3,
        device=device,
        dtype=dtype or ("bfloat16" if fp16 else "float32"),
        use_bbd=use_bbd,
    )


def is_completed(utterance: str) -> bool:
    return utterance.endswith((".", "?", "!"))


def upper_case_first_letter(text: str) -> str:
    if text and text[0].islower():
        return text[0].upper() + text[1:]
    return text


def linear_interpolate_positions(positions: List[float]) -> List[float]:
    """Spread runs of identical token positions into a linear ramp.

    Tokens committed within one block share an encoder frame, so raw
    per-token positions arrive in plateaus; each run of equal values is
    replaced by a ramp from the previous distinct value (0 before the
    first run) up to the run's value, with the run's last element kept
    exact: [5, 5, 5] -> [1.67, 3.33, 5]. Behind --interpolate-timestamps;
    off by default, so default output keeps the plateaus."""
    out: List[float] = []
    prev = 0.0
    i, n = 0, len(positions)
    while i < n:
        j = i
        while j < n and positions[j] == positions[i]:
            j += 1
        cur = float(positions[i])
        run = j - i
        out.extend(prev + (k / run) * (cur - prev)
                   for k in range(1, run + 1))
        prev = cur
        i = j
    return out


def _decode_segment(
    s2t: Speech2TextStreaming,
    speech: np.ndarray,
    start_sample: int,
    end_sample: int,
    chunk_length: int,
) -> Tuple[str, List[str], List[int]]:
    """Stream one segment through the session; returns (text, tokens,
    token positions in encoder frames from the segment's start)."""
    s2t.reset()
    results: List = []
    pos = start_sample
    while pos < end_sample:
        chunk = speech[pos : min(pos + chunk_length, end_sample)]
        is_final = pos + chunk_length >= end_sample
        results = s2t(chunk, is_final=is_final, finalize_all=True,
                      always_assemble_hyps=False)
        pos += chunk_length
    if not results:
        return "", [], []
    text, tokens, _ids, token_pos = results[0]
    return text, tokens, token_pos


def _split_overlong_spans(
    spans: List[Tuple[float, float]], max_segment_sec: float
) -> List[Tuple[float, float]]:
    """Split any span longer than the decode-state capacity into equal
    sub-spans below the bound. The CTC forward variables and cross-attention
    caches hold cfg.max_enc_frames encoder frames; past that the decode
    state would overflow (the beam search raises)."""
    out: List[Tuple[float, float]] = []
    for s0, s1 in spans:
        n = max(1, math.ceil((s1 - s0) / max_segment_sec))
        step = (s1 - s0) / n
        out.extend((s0 + i * step, s0 + (i + 1) * step) for i in range(n))
    return out


def _decode_segments_batched(
    s2t: Speech2TextStreaming,
    speech: np.ndarray,
    spans_samples: List[Tuple[int, int]],
    chunk_length: int,
    n_streams: int,
    progress_cb=None,
) -> List[Tuple[str, List[str], List[int]]]:
    """Decode a file's segments concurrently as streams of one batched
    engine on the session's device. Output is identical to the serial path:
    the engine is lockstep-equivalent to independent sessions and finals go
    through the same single-stream finalizer + assembly."""
    from speechcatcher_tpu_torch.serve.engine import StreamingEngine
    from speechcatcher_tpu_torch.streaming import assemble_hypothesis

    engine = StreamingEngine(
        s2t.model,
        n_slots=min(n_streams, len(spans_samples)),
        beam_size=s2t.beam_size,
        ctc_weight=s2t.ctc_weight,
        use_bbd=s2t.use_bbd,
        chunk_samples=chunk_length,
        device=s2t.model.device,
        lm_weight=s2t.beam_search.lm_weight,
    )
    results: List = [None] * len(spans_samples)
    pending = list(enumerate(spans_samples))[::-1]  # pop() from the front
    active: dict = {}  # slot -> [idx, pos, end]
    while pending or active:
        while pending:
            slot = engine.acquire_slot()
            if slot is None:
                break
            idx, (s0, s1) = pending.pop()
            active[slot] = [idx, s0, s1]
        batch = {}
        final_slots = []
        for slot, (idx, pos, end) in active.items():
            # Mirror the serial driver: the last chunk (remaining <=
            # chunk_length) goes through finalize.
            if end - pos > chunk_length:
                batch[slot] = speech[pos : pos + chunk_length]
                active[slot][1] = pos + chunk_length
            else:
                final_slots.append(slot)
        if batch:
            engine.tick(batch)
        if final_slots:
            idx_of = {}
            tails = {}
            for slot in final_slots:
                idx, pos, end = active.pop(slot)
                idx_of[slot] = idx
                tails[slot] = speech[pos:end]
            done = engine.finalize_batch(tails)
            if set(done) != set(tails):
                raise RuntimeError(
                    f"segments {sorted(idx_of[s] for s in tails if s not in done)}"
                    " failed to finalize")
            for slot, (yseq, xpos, _score) in done.items():
                res = assemble_hypothesis(
                    s2t.cfg, s2t.tokenizer, yseq, xpos, is_final=True
                )
                results[idx_of[slot]] = (
                    (res[0][0], res[0][1], res[0][3]) if res else ("", [], [])
                )
                if progress_cb is not None:
                    progress_cb()
    return results


def recognize(
    s2t: Speech2TextStreaming,
    raw_speech_data: np.ndarray,
    rate: int,
    chunk_length: int = 8192,
    num_processes: int = 1,
    progress: bool = True,
    quiet: bool = False,
    status=None,
    interpolate_timestamps: bool = False,
):
    """Transcribe int16 PCM → (complete_text, auxiliary_info).
    num_processes > 1 decodes the energy segments concurrently as streams
    of one batched engine (num_processes = -1: auto); 1 decodes serially.
    interpolate_timestamps spreads same-block token plateaus into linear
    ramps (see linear_interpolate_positions)."""
    if rate != 16000:
        raise ValueError(f"recognize takes 16 kHz audio, got {rate} Hz")
    speech = raw_speech_data.astype(np.float32) / 32767.0
    total_sec = len(speech) / rate

    # Energy segmentation of long audio.
    boundaries_sec = [0.0]
    if len(speech) > 60.0 * rate:
        segments = segment_speech(raw_speech_data, rate)
        ends = [
            seg[1] / 100.0
            for seg in segments
            if seg[1] < (total_sec - 10.0) * 100.0
        ]
        boundaries_sec += ends
    boundaries_sec.append(total_sec)
    spans = list(zip(boundaries_sec[:-1], boundaries_sec[1:]))

    # Decode-state capacity bound: never hand one segment more audio than
    # max_enc_frames can hold (with 10% margin for look-ahead staging).
    frame_sec = s2t.cfg.hop_length * s2t.cfg.subsample / s2t.cfg.sample_rate
    max_segment_sec = 0.9 * s2t.cfg.max_enc_frames * frame_sec
    spans = _split_overlong_spans(spans, max_segment_sec)

    if num_processes == -1:
        num_processes = min(8, len(spans))

    paragraphs: List[Tuple[str, List[str], List[float]]] = []
    bar = None
    if progress and not quiet:
        try:
            from tqdm import tqdm

            bar = tqdm(total=len(spans), desc="Transcribing")
        except ImportError:
            pass

    if num_processes > 1 and len(spans) > 1:
        spans_samples = [
            (int(s0 * rate), int(s1 * rate)) for s0, s1 in spans
        ]
        seg_results = _decode_segments_batched(
            s2t, speech, spans_samples, chunk_length, num_processes,
            progress_cb=(bar.update if bar is not None else None),
        )
    else:
        seg_results = []
        for seg_start, seg_end in spans:
            seg_results.append(_decode_segment(
                s2t,
                speech,
                int(seg_start * rate),
                int(seg_end * rate),
                chunk_length,
            ))
            if bar is not None:
                bar.update()
            if status is not None:
                pct = 100.0 * seg_end / total_sec
                status.publish_status(f"Decoding progress: {pct:.2f}%")
    # Positions to seconds in one place for both paths, so that they give
    # the same floats (interpolating seconds instead of positions differs
    # in the last bit).
    for (seg_start, _seg_end), (text, toks, pos) in zip(spans, seg_results):
        if interpolate_timestamps:
            pos = linear_interpolate_positions(pos)
        paragraphs.append(
            (text, toks, [seg_start + p * frame_sec for p in pos]))
    if bar is not None:
        bar.close()

    # Paragraph merging: only split where the model also ended a sentence.
    merged: List[str] = []
    aux: List[dict] = []
    for (text, toks, ts), (seg_start, seg_end) in zip(paragraphs, spans):
        if merged and not is_completed(merged[-1]):
            merged[-1] += " " + text
            aux[-1]["end"] = seg_end
            aux[-1]["text"] += " " + text
            aux[-1]["tokens"].extend(toks)
            aux[-1]["token_timestamps"].extend(ts)
        else:
            text = upper_case_first_letter(text)
            merged.append(text)
            aux.append(
                {
                    "start": seg_start,
                    "end": seg_end,
                    "text": text,
                    "tokens": toks,
                    "token_timestamps": ts,
                }
            )

    complete_text = "\n\n".join(merged) + "\n"
    return complete_text, aux


def recognize_file(
    s2t: Speech2TextStreaming,
    media_path: str,
    output_file: str = "",
    quiet: bool = True,
    progress: bool = True,
    num_processes: int = -1,
    chunk_length: int = 8192,
    show_ffmpeg_output: bool = False,
    interpolate_timestamps: bool = False,
) -> dict:
    """Decode a media file; write <name>.txt and <name>.json."""
    data, rate = convert_media(media_path, show_output=show_ffmpeg_output)
    complete_text, aux = recognize(
        s2t, data, rate, chunk_length=chunk_length, progress=progress,
        quiet=quiet, num_processes=num_processes,
        interpolate_timestamps=interpolate_timestamps,
    )

    if output_file == "":
        base = media_path.split("/")[-1] if media_path.startswith(
            ("http://", "https://")
        ) else media_path
        out_txt, out_json = base + ".txt", base + ".json"
    else:
        out_txt, out_json = output_file + ".txt", output_file + ".json"

    with open(out_txt, "w") as f:
        f.write(complete_text)
    complete = {"complete_text": complete_text, "paragraphs": aux}
    with open(out_json, "w") as f:
        json.dump(complete, f, indent=4, ensure_ascii=False)
    print(f"Wrote transcription to {out_txt} and {out_json}.")
    return complete


def list_microphones():
    """Print all input-capable audio devices."""
    try:
        import pyaudio
    except ImportError:
        print("pyaudio is not installed — cannot enumerate microphones.")
        return
    p = pyaudio.PyAudio()
    info = p.get_host_api_info_by_index(0)
    for i in range(info.get("deviceCount", 0)):
        dev = p.get_device_info_by_host_api_device_index(0, i)
        if dev.get("maxInputChannels", 0) > 0:
            print("Input Device id ", i, " - ", dev.get("name"))


def _read_mic_chunk_with_advice(stream, chunksize, prev_lines_fn,
                                exception_on_overflow=True):
    """stream.read with remediation advice on input overflow: overflow
    means decoding fell behind real time; tell the user how to recover
    instead of dumping a traceback."""
    try:
        return stream.read(chunksize,
                           exception_on_overflow=exception_on_overflow)
    except OSError as e:
        if "Input overflowed" in str(e):
            print("\n")
            print("Input overflowed while fetching new data from your "
                  "microphone.")
            print("This happens when online recognition is not fast enough "
                  "to decode speech in real time.")
            print("---")
            print("Solution 1: silently discard this error with the "
                  "--no-exception-on-overflow option. This may degrade "
                  "recognition quality, as some speech data is discarded to "
                  "catch up with the newest microphone data.")
            print("or")
            print("Solution 2: reduce the beam size, e.g. -b 1. A smaller "
                  "beam decodes faster with slightly less accuracy.")
            print("and/or")
            print("Solution 3: use a smaller and faster model (-m ..._m).")
            # prev_lines_fn reads the CURRENT rendered-line count at
            # exception time (the future was submitted before the latest
            # render, so a plain value would be stale).
            print(prev_lines_fn() * "\n")
        else:
            print("An OS error occurred:", e)
        sys.exit(-1)


def recognize_microphone(
    s2t: Speech2TextStreaming,
    tag: str,
    record_max_seconds: float = 120,
    samplerate: int = 16000,
    chunksize: int = 8192,
    save_debug_wav: bool = False,
    exception_on_pyaudio_overflow: bool = True,
    finalize_update_iters: int = 7,
):
    """Live microphone transcription with plateau endpointing. Requires
    pyaudio."""
    try:
        import pyaudio
    except ImportError:
        print("pyaudio is not installed — live transcription unavailable.")
        sys.exit(1)

    from concurrent.futures import ThreadPoolExecutor

    from speechcatcher_tpu_torch.utils.term import progress_output

    list_microphones()
    p = pyaudio.PyAudio()
    stream = p.open(
        format=pyaudio.paInt16, channels=1, rate=samplerate, input=True,
        frames_per_buffer=chunksize,
    )
    print(f"Model {tag} loaded, starting live transcription.")
    blocks = []
    n_best_lens: List[int] = []
    results = []
    prev_lines = 0

    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(
            _read_mic_chunk_with_advice, stream, chunksize,
            lambda: prev_lines, exception_on_pyaudio_overflow,
        )
        for i in range(int(samplerate / chunksize * record_max_seconds) + 1):
            data = np.frombuffer(fut.result(timeout=2), dtype=np.int16)
            fut = ex.submit(
                _read_mic_chunk_with_advice, stream, chunksize,
                lambda: prev_lines, exception_on_pyaudio_overflow,
            )
            if save_debug_wav:
                blocks.append(data)
            audio = data.astype(np.float32) / 32767.0

            # Plateau endpointing: finalize when the partial-text length has
            # not changed for the recent iterations (at least
            # finalize_update_iters of them, then the last 10).
            finalize = False
            if len(n_best_lens) >= finalize_update_iters:
                if all(x == n_best_lens[-1] for x in n_best_lens[-10:]):
                    finalize = True
                    n_best_lens = []
            results = s2t(audio, is_final=finalize)
            if results:
                text = results[0][0]
                n_best_lens.append(len(text))
                prev_lines = progress_output(text, prev_lines)
            else:
                prev_lines = progress_output("", prev_lines)
            if finalize:
                sys.stdout.write("\n")
                prev_lines = 0

    if save_debug_wav and blocks:
        from speechcatcher_tpu_torch.utils.audio import write_wav

        write_wav(Path("debug.wav"), np.concatenate(blocks), samplerate)
    print("\nMaximum recording time reached, exiting.")
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="speechcatcher_tpu_torch — decode speech with streaming "
        "models on an NVIDIA GPU."
    )
    parser.add_argument("-l", "--live-transcription", dest="live",
                        action="store_true",
                        help="Use microphone for live transcription")
    parser.add_argument("-t", "--max-record-time", dest="max_record_time",
                        type=float, default=120)
    parser.add_argument("-m", "--model", dest="model",
                        default="de_streaming_transformer_xl",
                        help="Model tag, HuggingFace id, URL, or local dir")
    parser.add_argument("-d", "--device", dest="device", default="cuda",
                        choices=["cuda", "cpu"],
                        help="cuda (the default) or cpu; cuda raises on a "
                        "machine without it")
    parser.add_argument("-b", "--beamsize", dest="beamsize", type=int,
                        default=5)
    parser.add_argument("--fp16", dest="fp16", action="store_true",
                        help="Reduced precision (bfloat16) for faster "
                        "inference")
    parser.add_argument("--disable-bbd", dest="disable_bbd",
                        action="store_true")
    parser.add_argument("--quiet", dest="quiet", action="store_true")
    parser.add_argument("--no-progress", dest="no_progress",
                        action="store_true")
    parser.add_argument("--save-debug-wav", dest="save_debug_wav",
                        action="store_true")
    parser.add_argument("--list-microphones", dest="list_microphones",
                        action="store_true",
                        help="List input audio devices and exit")
    parser.add_argument("--no-exception-on-overflow",
                        dest="no_exception_on_overflow", action="store_true",
                        help="Do not abort live recognition on microphone "
                        "input overflow (discards audio to catch up)")
    parser.add_argument("--cache-dir", dest="cache_dir",
                        default="~/.cache/speechcatcher_tpu")
    parser.add_argument("-n", "--num-processes", dest="num_processes",
                        type=int, default=-1,
                        help="Concurrent segment streams on the batched "
                        "engine (-1 = auto, 1 = serial); segments share one "
                        "weight copy on one card.")
    parser.add_argument("--chunk-length", dest="chunk_length", type=int,
                        default=8192)
    parser.add_argument("--log-level", dest="log_level", default="ERROR",
                        choices=["DEBUG", "INFO", "WARNING", "ERROR",
                                 "CRITICAL"])
    parser.add_argument("--show-ffmpeg-output", dest="show_ffmpeg_output",
                        action="store_true")
    parser.add_argument("--interpolate-timestamps",
                        dest="interpolate_timestamps", action="store_true",
                        help="spread same-block token-timestamp plateaus "
                             "into linear ramps (off = plateaus kept)")
    parser.add_argument("inputfile", nargs="?", default="")
    args = parser.parse_args(argv)

    logging.basicConfig(level=getattr(logging, args.log_level))

    if args.list_microphones:
        list_microphones()
        sys.exit(0)

    if not args.model.startswith(("http://", "https://")) and not Path(
        args.model
    ).exists():
        # "org/name" is a HuggingFace repo id — resolved by the zoo
        # downloader like the help text advertises, not a typo'd tag.
        if args.model not in tags and "/" not in args.model:
            print(f"Model {args.model} is not a valid model!")
            print("Options are:", ", ".join(tags.keys()))
            sys.exit(-1)

    s2t = load_model(
        tag=args.model,
        device=args.device,
        beam_size=args.beamsize,
        quiet=args.quiet,
        cache_dir=args.cache_dir,
        fp16=args.fp16,
        use_bbd=not args.disable_bbd,
    )

    if args.live:
        recognize_microphone(
            s2t, args.model, record_max_seconds=args.max_record_time,
            save_debug_wav=args.save_debug_wav,
            exception_on_pyaudio_overflow=not args.no_exception_on_overflow,
        )
    elif args.inputfile:
        if not args.inputfile.startswith(("http://", "https://")) and not Path(
            args.inputfile
        ).is_file():
            print(f"Error: input file '{args.inputfile}' does not exist.")
            sys.exit(-1)
        recognize_file(
            s2t, args.inputfile, quiet=args.quiet,
            progress=not args.no_progress, chunk_length=args.chunk_length,
            num_processes=args.num_processes,
            show_ffmpeg_output=args.show_ffmpeg_output,
            interpolate_timestamps=args.interpolate_timestamps,
        )
    else:
        parser.print_help()


if __name__ == "__main__":
    main()
