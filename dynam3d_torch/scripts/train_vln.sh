#!/usr/bin/env bash
# VLN IL training (the reference's scripts/main.bash train equivalent) on
# NPROC ranks of this host, one card each: data-parallel at NPROC > 1.
# torch.distributed.run is torchrun; it sets RANK / WORLD_SIZE / LOCAL_RANK.
set -euo pipefail
EXP=${1:-vln_exp}
shift || true
python -m torch.distributed.run --standalone --nproc_per_node="${NPROC:-1}" \
    -m dynam3d_torch.run --run-type train --trainer Dynam3D --exp_name "$EXP" "$@"
