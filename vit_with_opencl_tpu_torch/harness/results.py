"""Result-file emission and golden-file parity comparator.

Preserves the reference's verification contract bit-for-bit in behavior:
  * result line format ``[i] label: L / prob: P`` with 6-decimal probability
    (reference: Main.c:71);
  * comparison gate: exact top-1 label match plus probability within 0.01
    (reference: comparator.c:74-86).

Two deliberate divergences from the reference, both documented in SURVEY.md's
quirks appendix:
  * the argmax is reset per image (the reference carries ``pred_idx`` across
    images and can never select index 0 — Main.c:59-69, a latent bug);
  * the comparator takes the image count from the answer file instead of a
    hard-coded 100 (comparator.c:9).
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

_LINE_RE = re.compile(r"^\[\s*(\d+)\s*\]\s*label:\s*(\d+)\s*/\s*prob:\s*([-0-9.eE+]+)")


def argmax_predictions(probs: np.ndarray) -> List[Tuple[int, float]]:
    """Per-image (label, prob) via a correct, per-image-reset argmax."""
    probs = np.asarray(probs)
    out = []
    for row in probs:
        idx = int(np.argmax(row))
        out.append((idx, float(row[idx])))
    return out


def format_result_line(index: int, label: int, prob: float) -> str:
    """Exact reference line format (reference: Main.c:71)."""
    return f"[{index}] label: {label} / prob: {prob:.6f}"


def write_results(path: str | os.PathLike, probs: np.ndarray) -> List[Tuple[int, float]]:
    """Write one line per image; returns the (label, prob) predictions."""
    preds = argmax_predictions(probs)
    with open(path, "w") as f:
        for i, (label, prob) in enumerate(preds):
            f.write(format_result_line(i, label, prob) + "\n")
    return preds


def parse_result_line(line: str) -> Optional[Tuple[int, float]]:
    """Parse ``[i] label: L / prob: P`` → (label, prob)
    (reference: comparator.c:12-16)."""
    m = _LINE_RE.match(line.strip())
    if not m:
        return None
    return int(m.group(2)), float(m.group(3))


def evaluate_accuracy(
    probs: np.ndarray, labels: Sequence[int], topk: Tuple[int, ...] = (1, 5)
) -> dict:
    """Top-k accuracy against ground-truth labels (the eval the reference's
    setup implies — its fixtures are ImageNet-1k — but never implements)."""
    probs = np.asarray(probs)
    labels = np.asarray(list(labels))
    if len(labels) != probs.shape[0]:
        raise ValueError(
            f"{probs.shape[0]} predictions but {len(labels)} labels"
        )
    order = np.argsort(-probs, axis=-1)
    out = {"n": int(probs.shape[0])}
    for k in topk:
        hits = (order[:, :k] == labels[:, None]).any(axis=1)
        out[f"top{k}"] = float(hits.mean())
    return out


def load_label_file(path: str | os.PathLike) -> List[int]:
    """One integer class id per line (blank lines ignored)."""
    with open(path) as f:
        return [int(line) for line in f.read().split()]


def compare_result_files(
    result_path: str | os.PathLike,
    answer_path: str | os.PathLike,
    *,
    image_count: Optional[int] = None,
    prob_tol: float = 0.01,
    verbose: bool = True,
) -> int:
    """Line-by-line parity check; returns the error count (0 = pass).

    Mirrors ``comparator()`` (reference: comparator.c:26-92): label must match
    exactly, probability within ``prob_tol`` (0.01). ``image_count`` defaults
    to the answer file's line count.
    """
    with open(answer_path) as f:
        answer_lines = [l for l in f.read().splitlines() if l.strip()]
    with open(result_path) as f:
        result_lines = [l for l in f.read().splitlines() if l.strip()]
    if image_count is None:
        image_count = len(answer_lines)

    errors = 0
    for i in range(image_count):
        if i >= len(result_lines) or i >= len(answer_lines):
            if verbose:
                print(f"Line {i}: file has too few lines")
            errors += 1
            break
        r = parse_result_line(result_lines[i])
        a = parse_result_line(answer_lines[i])
        if r is None or a is None:
            if verbose:
                print(f"Line {i}: parse error")
            errors += 1
            continue
        label_r, prob_r = r
        label_a, prob_a = a
        if label_r != label_a:
            if verbose:
                print(f"Line {i}: Label mismatch (Result: {label_r}, Answer: {label_a})")
            errors += 1
        if abs(prob_r - prob_a) > prob_tol:
            if verbose:
                print(
                    f"Line {i}: Probability mismatch "
                    f"(Result: {prob_r:.6f}, Answer: {prob_a:.6f})"
                )
            errors += 1
    return errors
