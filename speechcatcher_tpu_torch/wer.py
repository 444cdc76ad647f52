"""WER/CER computation over Kaldi-style `text` files (port of
``speechcatcher_tpu/wer.py``).

Self-contained: regex word tokenization with camel-case splitting,
Levenshtein alignment for WER/CER, Kaldi `uttid text` I/O.
"""

from __future__ import annotations

import argparse
import re
import string
import sys
from typing import Dict, List, Tuple


def tokenize(text: str, split_camel_case: bool = True) -> List[str]:
    if split_camel_case:
        text = re.sub(r"(?<=[a-zäöüß])(?=[A-ZÄÖÜ])", " ", text)
    return [t for t in re.split(r"\s+", text.strip()) if t]


def normalize(text: str, ignore_punct: bool = True,
              lowercase: bool = True) -> str:
    if ignore_punct:
        text = text.translate(str.maketrans("", "", string.punctuation + "„“”‚‘’–…"))
    if lowercase:
        text = text.lower()
    return text


def edit_distance_counts(ref: List, hyp: List) -> Tuple[int, int, int]:
    """(substitutions, deletions, insertions) via Levenshtein alignment."""
    m, n = len(ref), len(hyp)
    # dp[i][j] = (cost, subs, dels, ins)
    prev = [(j, 0, 0, j) for j in range(n + 1)]
    for i in range(1, m + 1):
        cur = [(i, 0, i, 0)] + [None] * n
        for j in range(1, n + 1):
            if ref[i - 1] == hyp[j - 1]:
                cand = [(prev[j - 1][0], prev[j - 1])]
            else:
                cand = [(prev[j - 1][0] + 1, ("s", prev[j - 1]))]
            cand.append((prev[j][0] + 1, ("d", prev[j])))
            cand.append((cur[j - 1][0] + 1, ("i", cur[j - 1])))
            cost, info = min(cand, key=lambda c: c[0])
            if isinstance(info, tuple) and len(info) == 2 and info[0] in "sdi":
                op, base = info
                s, d, ins = base[1], base[2], base[3]
                if op == "s":
                    s += 1
                elif op == "d":
                    d += 1
                else:
                    ins += 1
                cur[j] = (cost, s, d, ins)
            else:
                cur[j] = (cost, info[1], info[2], info[3])
        prev = cur
    _, s, d, ins = prev[n]
    return s, d, ins


def word_error_rate(refs: List[str], hyps: List[str],
                    ignore_punct: bool = True,
                    lowercase: bool = True) -> Dict[str, float]:
    """Corpus WER/CER with substitution/deletion/insertion breakdown."""
    tot_words = tot_chars = 0
    w_s = w_d = w_i = 0
    c_s = c_d = c_i = 0
    for ref, hyp in zip(refs, hyps):
        ref_n, hyp_n = normalize(ref, ignore_punct, lowercase), normalize(
            hyp, ignore_punct, lowercase
        )
        rw, hw = tokenize(ref_n), tokenize(hyp_n)
        s, d, i = edit_distance_counts(rw, hw)
        w_s += s
        w_d += d
        w_i += i
        tot_words += len(rw)
        rc, hc = list(" ".join(rw)), list(" ".join(hw))
        s, d, i = edit_distance_counts(rc, hc)
        c_s += s
        c_d += d
        c_i += i
        tot_chars += len(rc)
    wer = (w_s + w_d + w_i) / max(tot_words, 1)
    cer = (c_s + c_d + c_i) / max(tot_chars, 1)
    return {
        "wer": wer,
        "cer": cer,
        "substitutions": w_s,
        "deletions": w_d,
        "insertions": w_i,
        "words": tot_words,
    }


def read_kaldi_text(path: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split(maxsplit=1)
            if len(parts) == 2:
                out[parts[0]] = parts[1]
            elif len(parts) == 1:
                out[parts[0]] = ""
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Compute WER/CER between Kaldi-style text files."
    )
    parser.add_argument("ref", help="reference text file (uttid text)")
    parser.add_argument("hyp", help="hypothesis text file (uttid text)")
    parser.add_argument("--keep-punctuation", action="store_true")
    parser.add_argument("--keep-case", action="store_true")
    args = parser.parse_args(argv)

    refs = read_kaldi_text(args.ref)
    hyps = read_kaldi_text(args.hyp)
    common = sorted(set(refs) & set(hyps))
    if not common:
        print("No common utterance ids.", file=sys.stderr)
        sys.exit(1)
    metrics = word_error_rate(
        [refs[k] for k in common],
        [hyps[k] for k in common],
        ignore_punct=not args.keep_punctuation,
        lowercase=not args.keep_case,
    )
    print(
        f"WER: {metrics['wer']:.4f}  CER: {metrics['cer']:.4f}  "
        f"(S={metrics['substitutions']} D={metrics['deletions']} "
        f"I={metrics['insertions']} N={metrics['words']}, "
        f"{len(common)} utterances)"
    )


if __name__ == "__main__":
    main()
