#!/usr/bin/env bash
# VLN evaluation (scripts/main.bash eval equivalent) on NPROC ranks of this
# host, one card each; the episodes are sharded by rank and rank 0 writes
# the stats merged over all of them.
set -euo pipefail
EXP=${1:-vln_exp}
shift || true
python -m torch.distributed.run --standalone --nproc_per_node="${NPROC:-1}" \
    -m dynam3d_torch.run --run-type eval --trainer Dynam3D --exp_name "$EXP" "$@"
