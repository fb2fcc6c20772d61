"""Baseline (ratchet) engine for tbx-check findings.

A baseline is a JSON file of finding *fingerprints*: hashes of
``(rule, module-relative qualname, normalized snippet)``.  Line numbers AND
directory paths are both excluded, so neither unrelated edits above a known
finding nor a pure file move churn the committed file.  Workflow:

    python -m taboo_brittleness_tpu_torch.analysis --deep \\
        --write-baseline taboo_brittleness_tpu_torch/analysis/tbx_baseline.json ...
    python -m taboo_brittleness_tpu_torch.analysis --deep \\
        --baseline taboo_brittleness_tpu_torch/analysis/tbx_baseline.json ...

``--baseline`` filters known findings out of the gate; anything NEW still
fails.  Deep-mode findings baseline the same way — they carry no scope, so
their synthetic ``<deep:entry>`` path anchors the hash instead, and their
snippet is the conversion description: both stable across edits.  The file
format and the fingerprints are the JAX checker's, so either checker reads
the other's files.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Iterable, List, Set, Tuple

from taboo_brittleness_tpu_torch.analysis.core import Finding

VERSION = 2


def fingerprint(finding: Finding) -> str:
    # Anchor on the in-module qualname when we have one; synthetic paths
    # ("<deep:...>") are already location-free and stay as-is.  Real-file
    # module-level findings anchor on "" — the normalized snippet + rule is
    # identity enough, and it is what makes a pure rename a no-op.
    if finding.path.startswith("<"):
        anchor = finding.path
    else:
        anchor = finding.scope
    snippet = " ".join((finding.snippet or finding.message).split())
    basis = f"{finding.code}::{anchor}::{snippet}"
    return hashlib.sha1(basis.encode("utf-8")).hexdigest()[:16]


def save(findings: Iterable[Finding], path: str) -> int:
    entries = {}
    for f in findings:
        fp = fingerprint(f)
        # Keep one human-readable locator per fingerprint (the hash alone
        # would make the committed file unreviewable).  ``path`` is advisory
        # only — it is NOT part of the hash.
        entries.setdefault(fp, {
            "rule": f.code, "path": f.path, "scope": f.scope,
            "summary": f.message[:120]})
    doc = {"version": VERSION, "findings": entries}
    tmp = f"{path}.tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)
    return len(entries)


def load(path: str) -> Set[str]:
    with open(path, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    if not isinstance(doc, dict) or "findings" not in doc:
        raise ValueError(f"{path}: not a tbx-check baseline file")
    if doc.get("version", 1) != VERSION:
        raise ValueError(
            f"{path}: baseline version {doc.get('version')} != {VERSION}; "
            "regenerate with --write-baseline (v2 keys on rule+scope+snippet "
            "so file moves do not churn the ratchet)")
    return set(doc["findings"])


def split(findings: List[Finding],
          known: Set[str]) -> Tuple[List[Finding], List[Finding]]:
    """(new, baselined) partition of ``findings`` against a baseline set."""
    new: List[Finding] = []
    old: List[Finding] = []
    for f in findings:
        (old if fingerprint(f) in known else new).append(f)
    return new, old
