#!/bin/bash
# Round-4 card session: the card's name and power limit, the prefill
# attribution, the batched ring decode at B=4 (8 -> 32 token chains), then
# the default headline bench.  Appends to $1 (default
# chiprun_out/round4_card.log).
#
#   bash dynam3d_torch/scripts/round4_card_runs.sh [LOG]
set -u
cd "$(dirname "$0")/../.."
LOG="${1:-chiprun_out/round4_card.log}"
mkdir -p "$(dirname "$LOG")"
{
  echo "=== card $(date -u) ==="
  nvidia-smi --query-gpu=name,power.limit --format=csv,noheader

  echo "=== prof_prefill $(date -u) ==="
  python -u -m dynam3d_torch.tools.prof_prefill

  echo "=== batched ring decode B=4 (8->32 chains) $(date -u) ==="
  python -u -m dynam3d_torch.tools.ab_fused_decode --batch 4 --tokens 32,8 \
    --only ring --no-control

  echo "=== bench default (W8A8 prefill + lm_at headline) $(date -u) ==="
  python -u -m dynam3d_torch.tools.bench

  echo "=== done $(date -u) ==="
} >> "$LOG" 2>&1
