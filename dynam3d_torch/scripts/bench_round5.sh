#!/usr/bin/env bash
# Round-5 card sweep and host tripwires.
#
# Host legs first (no card time): speculation acceptance at both
# granularities, the tokenizer checker's self-test, and the copy check when
# DYNAM3D_COPYCHECK_REF names the reference tree to compare with.  Card
# legs, one after another: the headline under the 50-step protocol, the IL
# step at B=1 and B=8, a 3DFF pretraining iteration, the 12-view waypoint
# call, the B=1 full-step chain; with DYNAM3D_R5_SYNTH=1 also the full-size
# synthesized conversion round trip.
#
# Each leg's last line (one JSON object) is appended to
# runs/torch_bench_round5.jsonl, which the headline then attaches.
#
#   bash dynam3d_torch/scripts/bench_round5.sh
set -u
cd "$(dirname "$0")/../.."
OUT=runs/torch_bench_round5.jsonl
ERR=chiprun_out
mkdir -p runs "$ERR"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader >&2
export DYNAM3D_BENCH_BUDGET_S="${DYNAM3D_BENCH_BUDGET_S:-5200}"
run() {
  local name="$1"; shift
  echo "=== $name ($(date +%H:%M:%S)) ===" >&2
  ( set -o pipefail; "$@" 2>"$ERR/bench_r5_$name.err" | tail -1 \
      | sed "s/^/{\"mode\": \"$name\", \"line\": /; s/$/}/" ) >> "$OUT" \
    || echo "{\"mode\": \"$name\", \"error\": true}" >> "$OUT"
}

# --- host tripwires first (fail fast, no card time) ---
run spec_acceptance python -u -m dynam3d_torch.tools.spec_acceptance --json
run check_tokenizer python -u -m dynam3d_torch.tools.check_tokenizer --self-test --json
if [ -n "${DYNAM3D_COPYCHECK_REF:-}" ]; then
  run copycheck python -u -m dynam3d_torch.tools.copycheck --json \
    --reference "$DYNAM3D_COPYCHECK_REF"
fi

# --- card legs ---
run headline  env DYNAM3D_BENCH_STEPS=50 python -u -m dynam3d_torch.tools.bench
run train     env DYNAM3D_BENCH_MODE=train DYNAM3D_BENCH_STEPS=6 python -u -m dynam3d_torch.tools.bench
run train_b8  env DYNAM3D_BENCH_MODE=train DYNAM3D_BENCH_STEPS=4 DYNAM3D_BENCH_BATCH=8 python -u -m dynam3d_torch.tools.bench
run pretrain  env DYNAM3D_BENCH_MODE=pretrain DYNAM3D_BENCH_STEPS=3 python -u -m dynam3d_torch.tools.bench
run waypoint  env DYNAM3D_BENCH_MODE=waypoint python -u -m dynam3d_torch.tools.bench
run full_step_chain python -u -m dynam3d_torch.tools.prof_full_step

# --- optional: the full-size synthesized conversion round trip ---
if [ "${DYNAM3D_R5_SYNTH:-0}" = "1" ]; then
  run parity_synth python -u -m dynam3d_torch.tools.parity_run \
    --synth --scale full --no-episode --out chiprun_out/parity_conv_r5
fi
echo "done -> $OUT" >&2
