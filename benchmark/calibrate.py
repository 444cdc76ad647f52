"""Readings behind a serving cell's limits (``benchmark/checks/<cell>.json``):
the program's on many seeds, the control's and the planted faults', in one
process on the card.

    python3 benchmark/calibrate.py --workload <cell> --seconds 15 \
        --seeds 11 12 13 ... [--control-seeds 3] [--fault half]

The program is built and captured once, and each seed's traffic is served
for ``--seconds``. For each seed it prints one JSON line, every reading with
the verdict (``correct``) that ``benchmark.harness.check.verdict`` gives it
under the cell's limits:

- ``program``: the check's readings of the served finals (what a benchmark
  run compares);
- ``control`` and ``control_card_tf32`` (first ``--control-seeds`` seeds):
  the configuration's reference (``Cell.reference``) in the program's
  place, in the precision below the configuration's (every product's
  operands in TF32, the reference's ``in_tf32``; the card's own TF32 mode),
  scoring the same sample, judged against the float32 reference: the
  control must fail;
- ``altered``: the served finals with one token each replaced by another
  id: the fault "a token altered where it is produced";
- ``fault`` with ``--fault half``: a run in which every tick feeds only half
  of its streams' chunks to the engine (the rest are dropped): the fault
  "half of the batch left out".

With ``--base-seeds b1 b2 ...`` every seed is served under weights drawn
from each bN instead of the configuration's ``weights_seed`` (written into
the captured parameters in place: the graphs read them where they lie); with
``--work-only`` only the work is printed (tokens a second of audio,
latencies, spans): how a configuration's ``weights_seed`` is chosen.

Not run by the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.harness import cell as cells  # noqa: E402


@contextlib.contextmanager
def card_tf32():
    """The card's own TF32 mode for cuBLAS and cuDNN."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def controlled(ref, picked, chunk: int, beam: int, lower):
    """The control in the program's place: copies of the picked finals,
    each scored at its served tokens and positions by the reference within
    `lower()`, the precision below the configuration's float32, TF32: the
    reference module's ``in_tf32`` (every product's operands rounded to
    TF32) or ``card_tf32`` (the card's own TF32 mode)."""
    from benchmark.harness import check

    out = []
    for sv in picked:
        yseq, xpos, _ = sv.result
        chunks = check.chunks_of(sv.utt.pcm, sv.tail, chunk)
        if chunks is None:
            continue
        with lower():
            enc = ref.encode(chunks)
            score = ref.rescore(enc, ref.ctc_logp(enc), yseq, xpos,
                                beam).score
        out.append(dataclasses.replace(sv, result=(yseq, xpos, score)))
    return out


def judged(readings, cell):
    """Readings with the verdict they give under the cell's limits."""
    from benchmark.harness import check

    return dict(readings, correct=check.verdict(readings, cell.checks))


def altered(served, seed: int, vocab: int):
    """Copies of the served finals, one token of each replaced by another
    id (not blank, not EOS)."""
    rng = np.random.default_rng(seed)
    out = []
    for sv in served:
        if sv.result is None or len(sv.result[0]) < 3:
            continue
        yseq, xpos, score = sv.result
        yseq = yseq.copy()
        j = int(rng.integers(1, len(yseq) - 1))
        tok = int(yseq[j])
        while tok in (int(yseq[j]), 0, vocab - 1):
            tok = int(rng.integers(1, vocab - 1))
        yseq[j] = tok
        clone = type(sv)(**{**sv.__dict__, "result": (yseq, xpos, score)})
        out.append(clone)
    return out


def drop_half(engine):
    """Plant the fault: every tick passes only every other stream's chunk
    to the engine."""
    tick = engine.tick

    def half(audio):
        keep = sorted(audio)[::2]
        return tick({s: audio[s] for s in keep})

    engine.tick = half
    return lambda: setattr(engine, "tick", tick)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault", choices=("half",), default=None)
    ap.add_argument("--base-seeds", type=int, nargs="*", default=None,
                    help="weights drawn from each of these instead of the "
                         "configuration's weights_seed, each with every "
                         "--seeds (how the draw moves the work)")
    ap.add_argument("--work-only", action="store_true",
                    help="serve and count the work; judge nothing")
    args = ap.parse_args()

    import torch

    from benchmark.harness import check, serve, weights
    from benchmark.harness.traffic import Traffic

    device = "cuda"
    cell = cells.load(args.workload, args.seeds[0], args.seconds, False,
                      cells.process_seconds())
    reference = cell.reference
    m = cell.config["model"]
    bias = cell.config["emission_bias"]
    base = cell.config["weights_seed"]
    tree = weights.make_tree(m, bias, base, device, reference.weight_specs)
    system = serve.System(m, tree, cell.traffic, device)
    serve.warm_up(system, Traffic(cell.traffic, args.seeds[0]))
    runs = [(base, s) for s in args.seeds]
    if args.base_seeds:
        runs = [(b, s) for b in args.base_seeds for s in args.seeds]
    loaded = cell.config["weights_seed"]
    for i, (base, seed) in enumerate(runs):
        cell.seed = seed
        if base != loaded:
            tree = weights.make_tree(m, bias, base, device,
                                     reference.weight_specs)
            weights.copy_into(system.model.params, tree)
            loaded = base
        undo = drop_half(system.engine) if args.fault else None
        out = serve.serve_window(system, Traffic(cell.traffic, seed), cell)
        if undo:
            undo()
        system.close()
        done = [sv for sv in out["served"] if sv.result is not None]
        line = {"seed": seed, "weights_seed": base, "workload": cell.name,
                "e2e": out["e2e"], "spans": out["record"]["spans"],
                "counts": out["counts"], "failed": out["failed"],
                "tokens_per_audio_s": sum(len(sv.result[0]) - 1 for sv in done)
                / max(sum(len(sv.utt.pcm) for sv in done) / 16000.0, 1e-9)}
        if args.work_only:
            print(json.dumps(line), flush=True)
            continue
        ref = reference.Reference(m, tree, device)
        line["program" if not args.fault else "fault"] = judged(
            serve.judge(ref, out["served"], cell), cell)
        if not args.fault:
            line["altered"] = judged(serve.judge(
                ref, altered(out["served"], seed, m["vocab_size"]), cell),
                cell)
            if i < args.control_seeds:
                spec = cell.traffic
                picked = check.sample(out["served"], cell.checks["sample"],
                                      seed)
                for key, lower in (("control", reference.in_tf32),
                                   ("control_card_tf32", card_tf32)):
                    line[key] = judged(check.reference_readings(
                        ref, controlled(ref, picked, spec["chunk_samples"],
                                        spec["beam"], lower),
                        spec["chunk_samples"], spec["beam"]), cell)
        print(json.dumps(line), flush=True)
        del ref, out
        gc.collect()
        torch.cuda.empty_cache()
    found = cells.forbidden_modules(sys.modules)
    if found:
        print(f"calibrate: loaded {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
