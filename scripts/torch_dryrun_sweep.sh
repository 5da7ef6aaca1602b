#!/bin/bash
# The port's full dry-run sweep: every arch on (32, 8) and on (2, 32, 8), at
# full width and full depth on fake tensors on the card, through the CLI
# (`python -m repro_torch.launch.dryrun`), one process per (arch, mesh), JOBS
# at a time.  Run from the repo root:
#
#     bash scripts/torch_dryrun_sweep.sh OUT_DIR [JOBS]
#
# Writes OUT_DIR/sweep_<arch>_<sp|mp>.{json,log} (each log ends with the
# process's exit code and wall seconds) and OUT_DIR/sweep_wall.txt; exits
# non-zero if any cell failed.
set -u
OUT=${1:?usage: torch_dryrun_sweep.sh OUT_DIR [JOBS]}
JOBS=${2:-8}
mkdir -p "$OUT"
export PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH} OUT
t0=$(date +%s)
for a in llama3-405b qwen3-moe-235b-a22b mixtral-8x22b falcon-mamba-7b gemma3-4b chatglm3-6b \
         h2o-danube-3-4b hymba-1.5b qwen2-vl-2b whisper-tiny; do
  for m in sp mp; do echo "$a $m"; done
done | xargs -P "$JOBS" -L 1 bash -c '
  flag=""; [ "$1" = mp ] && flag="--multi-pod"
  s=$(date +%s)
  timeout -k 10 2400 python -m repro_torch.launch.dryrun --arch "$0" --shape all $flag \
      --out "$OUT/sweep_$0_$1.json" > "$OUT/sweep_$0_$1.log" 2>&1
  echo "rc=$? wall $(( $(date +%s) - s )) s" >> "$OUT/sweep_$0_$1.log"'
echo "sweep wall $(( $(date +%s) - t0 )) s" > "$OUT/sweep_wall.txt"
cat "$OUT/sweep_wall.txt"
! grep -q "^FAIL\|^rc=[1-9]" "$OUT"/sweep_*.log
