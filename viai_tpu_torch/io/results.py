"""The results record that the port's CLIs append: one JSON line per
run, beside the eval CLI's."""

from __future__ import annotations

import json
import os


def append_record(rec: dict, results_dir: str):
    """Append one JSON record to the file VIAI_RESULTS_JSONL names, else
    to {results_dir}/quality_results.jsonl (never to the JAX package's
    scripts/quality_results.jsonl)."""
    out = os.environ.get("VIAI_RESULTS_JSONL") or os.path.join(
        results_dir, "quality_results.jsonl")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "a") as f:
        f.write(json.dumps(rec) + "\n")
