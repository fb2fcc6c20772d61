"""The port under the repo's static gate: JAX's ``tbx-check``
(``taboo_brittleness_tpu.analysis.run_check``, the rules the repo-wide gate
in ``tests/test_analysis.py`` runs over the JAX package, ``tools`` and
``tests``) reports nothing over ``taboo_brittleness_tpu_torch/``.  CLI
stdout and stderr contracts carry the JAX package's ``# tbx: TBX009-ok``
pragma, as its own CLI's prints do."""

import os

from taboo_brittleness_tpu.analysis import run_check

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_is_clean_under_tbx_check():
    report = run_check([os.path.join(REPO, "taboo_brittleness_tpu_torch")])
    assert report.findings == [], "\n".join(f.format() for f in report.findings)
    assert report.files_checked > 50
    # The pragmas are in use (the CLI's prints), not a rule gone quiet.
    assert any(f.code == "TBX009" for f in report.suppressed)
