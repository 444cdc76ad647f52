"""Standalone endpointing CLI: print the energy-based segments of a file
(port of ``speechcatcher_tpu/endpointing_cli.py``)."""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Cut long audio into ASR-sized segments at low-energy "
        "points."
    )
    parser.add_argument("-a", "--average-segment-length", type=float,
                        default=60.0)
    parser.add_argument("-m", "--max-segment-length", type=float,
                        default=180.0)
    parser.add_argument("-b", "--beam-size", type=int, default=10)
    parser.add_argument("-s", "--step", type=int, default=10)
    parser.add_argument("-lw", "--len-reward-weight", type=float, default=12.0)
    parser.add_argument("-ew", "--energy-weight", type=float, default=1.0)
    parser.add_argument("filename")
    args = parser.parse_args(argv)

    from speechcatcher_tpu_torch.endpointing import segment_speech
    from speechcatcher_tpu_torch.utils.audio import convert_media

    data, rate = convert_media(Path(args.filename))
    segments = segment_speech(
        data,
        rate,
        average_segment_length=args.average_segment_length,
        max_segment_len_sec=args.max_segment_length,
        beam_size=args.beam_size,
        step=args.step,
        len_reward_weight=args.len_reward_weight,
        energy_weight=args.energy_weight,
    )
    print(segments)


if __name__ == "__main__":
    main()
