#!/bin/bash
# Round-3 card measurement sequence in one session: the decode routes A/B,
# the per-part decode profile, the int8 prefill products, then the bench's
# render, serve and headline modes (the last also with the bf16 prefill).
# Appends everything to $LOG.
#
#   bash dynam3d_torch/scripts/round3_card_runs.sh
set -u
cd "$(dirname "$0")/../.."
LOG=${LOG:-chiprun_out/round3_card.log}
mkdir -p "$(dirname "$LOG")"

echo "=== $(date -u +%H:%M:%S) card ===" >> "$LOG"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader >> "$LOG" 2>&1

echo "=== $(date -u +%H:%M:%S) decode A/B (unfused/split/ring) ===" >> "$LOG"
python -u -m dynam3d_torch.tools.ab_fused_decode --tokens 128,8 >> "$LOG" 2>&1

echo "=== $(date -u +%H:%M:%S) per-part decode profile ===" >> "$LOG"
python -u -m dynam3d_torch.tools.prof_decode_parts >> "$LOG" 2>&1

echo "=== $(date -u +%H:%M:%S) int8-prefill matmul A/B ===" >> "$LOG"
python -u -m dynam3d_torch.tools.bench_int8_prefill >> "$LOG" 2>&1

echo "=== $(date -u +%H:%M:%S) render bench (56-frame walk table) ===" >> "$LOG"
DYNAM3D_BENCH_MODE=render DYNAM3D_BENCH_FRAMES=56 python -u -m dynam3d_torch.tools.bench >> "$LOG" 2>&1

echo "=== $(date -u +%H:%M:%S) serve bench (upload A/B) ===" >> "$LOG"
DYNAM3D_BENCH_MODE=serve python -u -m dynam3d_torch.tools.bench >> "$LOG" 2>&1

echo "=== $(date -u +%H:%M:%S) headline bench (default config, W8A8 prefill) ===" >> "$LOG"
python -u -m dynam3d_torch.tools.bench >> "$LOG" 2>&1

# W8A8 is the port's default prefill, so the A/B leg is the bf16 one
echo "=== $(date -u +%H:%M:%S) headline bench (bf16 prefill) ===" >> "$LOG"
DYNAM3D_W8A8_PREFILL=0 python -u -m dynam3d_torch.tools.bench >> "$LOG" 2>&1

echo "=== $(date -u +%H:%M:%S) done ===" >> "$LOG"
