#!/usr/bin/env bash
# Round-4 card sweep: the headline (with the speculation stats), the IL
# training step, a 3DFF pretraining iteration and the 12-view waypoint
# call, one mode after another; each mode's last line (one JSON object)
# is appended to runs/torch_bench_round4.jsonl, which the headline then
# attaches.
#
#   bash dynam3d_torch/scripts/bench_round4.sh
set -u
cd "$(dirname "$0")/../.."
OUT=runs/torch_bench_round4.jsonl
ERR=chiprun_out
mkdir -p runs "$ERR"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader >&2
export DYNAM3D_BENCH_BUDGET_S="${DYNAM3D_BENCH_BUDGET_S:-5200}"
run() {
  local name="$1"; shift
  echo "=== $name ($(date +%H:%M:%S)) ===" >&2
  ( set -o pipefail; "$@" 2>"$ERR/bench_r4_$name.err" | tail -1 \
      | sed "s/^/{\"mode\": \"$name\", \"line\": /; s/$/}/" ) >> "$OUT" \
    || echo "{\"mode\": \"$name\", \"error\": true}" >> "$OUT"
}
run headline  env DYNAM3D_BENCH_STEPS=12 python -m dynam3d_torch.tools.bench
run train     env DYNAM3D_BENCH_MODE=train DYNAM3D_BENCH_STEPS=6 python -m dynam3d_torch.tools.bench
run pretrain  env DYNAM3D_BENCH_MODE=pretrain DYNAM3D_BENCH_STEPS=3 python -m dynam3d_torch.tools.bench
run waypoint  env DYNAM3D_BENCH_MODE=waypoint python -m dynam3d_torch.tools.bench
echo "done -> $OUT" >&2
