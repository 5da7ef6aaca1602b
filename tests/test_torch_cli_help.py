"""The port's session CLI help texts pin its behaviour (the reference's
`tests/test_cli_help.py`, one counterpart a case).

argparse exits 0 on --help, so each case runs `_main` under
`pytest.raises(SystemExit)` and reads the captured text.  One difference is
by design: `ingest` has no `--shards` (the reference splits one HLO module
across processes; a capture dump is one rank's, and ingest fans out over
files).
"""
import re

import pytest

from repro.core.session import _main as ref_main
from repro_torch.core.session import _main

SUBCOMMANDS = ("demo", "ingest", "watch", "show", "table", "diff", "query", "lint",
               "detect", "report", "whatif")


def _help_of(argv, capsys, main=_main):
    with pytest.raises(SystemExit) as ei:
        main(argv + ["--help"])
    assert ei.value.code == 0
    return capsys.readouterr().out


def test_top_level_lists_every_subcommand_the_reference_has(capsys):
    out = _help_of([], capsys)
    listed = set(re.search(r"\{([a-z,]+)\}", out).group(1).split(","))
    ref = set(re.search(r"\{([a-z,]+)\}", _help_of([], capsys, ref_main)).group(1).split(","))
    assert listed == ref == set(SUBCOMMANDS)


def test_report_help_mentions_by_site_views(capsys):
    out = _help_of(["report"], capsys)
    assert "--by site" in out
    assert "--stream" in out and "--chunk-sites" in out


def test_whatif_help_documents_sweep_contract(capsys):
    out = _help_of(["whatif"], capsys)
    assert "--json" in out and "--top" in out
    assert "--mesh" in out and "--axes" in out
    assert "2 on input errors" in out
    assert "capture dump" in out


def test_ingest_help_documents_exit_codes(capsys):
    out = _help_of(["ingest"], capsys)
    for flag in ("--errors", "--retries", "--retry-backoff", "--timeout", "--workers",
                 "--json", "--no-compress"):
        assert flag in out
    assert "--shards" not in out
    assert "salvage" in out and "quarantined" in out
    assert "capture dump" in out


def test_watch_help_documents_daemon_flags(capsys):
    out = _help_of(["watch"], capsys)
    for flag in ("--fail-on", "--checkpoint", "--errors", "--once", "--settle", "--interval",
                 "--max-rounds"):
        assert flag in out
    assert "crash-resume" in out
    assert "*.jsonl" in out


def test_lint_and_detect_share_fail_on_contract(capsys):
    lint = _help_of(["lint"], capsys)
    det = _help_of(["detect"], capsys)
    for out in (lint, det):
        assert "--fail-on" in out and "--json" in out
    assert "critical" in lint     # lint's default
    assert "never" in det         # detect's default: advisory


@pytest.mark.parametrize("cmd", ["table", "diff", "query"])
def test_table_diff_and_query_document_site_mode(cmd, capsys):
    out = _help_of([cmd], capsys)
    assert "site" in out
