"""Decode a Kaldi-style data directory (wav.scp) to a `text_decoded` file
(port of ``speechcatcher_tpu/decode_kaldidir.py``).

Reads `wav.scp` entries (uttid → wav path or a command ending in '|'),
decodes each with the streaming session on the card (``--device cpu`` for
the CPU) and writes `uttid text` lines.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np


def read_wav_scp(path: Path):
    entries = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split(maxsplit=1)
            if len(parts) == 2:
                entries.append((parts[0], parts[1]))
    return entries


def load_entry(spec: str):
    """wav.scp value → int16 PCM @16k. Supports plain paths and trailing-pipe
    commands ('... |')."""
    from speechcatcher_tpu_torch.utils.audio import convert_media, resample_int16

    if spec.endswith("|"):
        out = subprocess.run(
            spec[:-1], shell=True, stdout=subprocess.PIPE, check=True
        ).stdout
        import io
        import wave

        with wave.open(io.BytesIO(out)) as w:
            rate = w.getframerate()
            data = np.frombuffer(
                w.readframes(w.getnframes()), dtype=np.int16
            )
        return resample_int16(data, rate), 16000
    return convert_media(Path(spec))


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Decode a Kaldi wav.scp test set."
    )
    parser.add_argument("datadir", help="directory containing wav.scp")
    parser.add_argument("-m", "--model", default="de_streaming_transformer_xl")
    parser.add_argument("-b", "--beamsize", type=int, default=5)
    parser.add_argument("-d", "--device", default="cuda",
                        choices=["cuda", "cpu"])
    parser.add_argument("--cache-dir", default="~/.cache/speechcatcher_tpu")
    parser.add_argument("-o", "--output", default="")
    args = parser.parse_args(argv)

    from speechcatcher_tpu_torch.recognize import load_model, recognize

    datadir = Path(args.datadir)
    scp = datadir / "wav.scp"
    if not scp.exists():
        print(f"No wav.scp in {datadir}", file=sys.stderr)
        sys.exit(1)

    s2t = load_model(args.model, device=args.device,
                     beam_size=args.beamsize, cache_dir=args.cache_dir)
    out_path = args.output or str(datadir / "text_decoded")
    with open(out_path, "w") as out:
        for uttid, spec in read_wav_scp(scp):
            try:
                pcm, rate = load_entry(spec)
                text, _aux = recognize(s2t, pcm, rate, progress=False,
                                       quiet=True)
                out.write(f"{uttid} {text.strip()}\n")
            except Exception as e:  # keep decoding the rest of the set
                print(f"{uttid}: {e}", file=sys.stderr)
                out.write(f"{uttid}\n")
    print(f"Wrote {out_path}")


if __name__ == "__main__":
    main()
