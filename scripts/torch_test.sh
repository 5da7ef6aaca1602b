#!/usr/bin/env sh
# The PyTorch port's test gate, on the CPU: run from the repo root.  Extra
# args pass through to pytest (e.g. `scripts/torch_test.sh -k inloop`).
#
#   scripts/torch_test.sh             # every tests/test_torch_*.py (card tests skip)
#   TIER=smoke scripts/torch_test.sh  # the back half's CI drills in one command:
#                                     # its tests, lint and what-if on a capture
#                                     # dump, a `session watch --once` smoke, the
#                                     # chaos gate (corrupt-dump matrix) and the
#                                     # warehouse smoke (200-host fleet ingest,
#                                     # mmap query, fleet diff); no jax runs
# Each step stops the script on a non-zero exit.  Outputs go under
# build/torch_smoke/ (git-ignored).
set -u
cd "$(dirname "$0")/.."
PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"
export PYTHONPATH
OUT=build/torch_smoke

if [ "${TIER:-full}" = "smoke" ]; then
    python -m pytest -x -q \
        tests/test_torch_backhalf.py tests/test_torch_ingest.py \
        tests/test_torch_watch.py tests/test_torch_chaos.py \
        tests/test_torch_append.py tests/test_torch_warehouse.py \
        tests/test_torch_cli_help.py \
        "$@" || exit $?
    rm -rf "$OUT/lint" "$OUT/watch" "$OUT/warehouse"
    # lint and what-if on a capture dump written from the synthetic workload
    python -c "import sys; sys.path.insert(0, 'src'); \
from repro_torch.core.synth import write_capture_dump; \
write_capture_dump('$OUT/lint', n_files=1, sites_per_file=400, seed=0)" || exit $?
    python -m repro_torch.core.session lint "$OUT"/lint/*.jsonl \
        --mesh 2,4 --axes data,model --fail-on critical || exit $?
    python -m repro_torch.core.session whatif "$OUT/lint/module_0000.jsonl" \
        --mesh 2,4 --axes data,model || exit $?
    # live-profiling smoke: drain a fleet dump directory in --once mode
    python -c "import sys; sys.path.insert(0, 'src'); \
from repro_torch.core.synth import write_fleet_dump; \
write_fleet_dump('$OUT/watch/dump', n_hosts=2, steps=1, sites_per_file=400, seed=0)" \
        || exit $?
    python -m repro_torch.core.session watch "$OUT/watch/dump" --once \
        --settle 0 --interval 0.05 --quiet \
        --summary "$OUT/watch/summary.json" \
        --report-json "$OUT/watch/report.json" || exit $?
    # chaos gate: the corrupt-dump matrix through ingest and the watch daemon
    python scripts/torch_chaos_smoke.py || exit $?
    # warehouse smoke: 200-host fleet dump -> uncompressed ingest -> mmap query/diff
    python -c "import sys; sys.path.insert(0, 'src'); \
from repro_torch.core.synth import write_fleet_dump; \
write_fleet_dump('$OUT/warehouse/dump', n_hosts=200, steps=1, sites_per_file=40, seed=0)" \
        || exit $?
    python -m repro_torch.core.session ingest "$OUT/warehouse/fleet.npz" \
        "$OUT"/warehouse/dump/*.jsonl --mesh 2,4 --axes data,model \
        --no-compress || exit $?
    python -m repro_torch.core.session query "$OUT/warehouse/fleet.npz" \
        --host '00*' --mmap --json > "$OUT/warehouse/query_00x.json" || exit $?
    python -m repro_torch.core.session query "$OUT/warehouse/fleet.npz" \
        --kind 'all-reduce*' --by semantic --mmap || exit $?
    python -m repro_torch.core.session diff "$OUT/warehouse/fleet.npz" \
        'host=00*' 'host=01*' --mmap --json \
        > "$OUT/warehouse/diff_00x_01x.json" || exit $?
    exit 0
fi

python -m pytest -x -q tests/test_torch_*.py "$@"
exit $?
