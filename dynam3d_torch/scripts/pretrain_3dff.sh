#!/usr/bin/env bash
# 3DFF pretraining (run_3dff/3dff.bash equivalent) on NPROC ranks of this
# host, one card each, data-parallel: every rank draws the same dataset each
# iteration and its own scenes and walks; rank 0 saves and logs.
set -euo pipefail
EXP=${1:-3dff_exp}
shift || true
python -m torch.distributed.run --standalone --nproc_per_node="${NPROC:-1}" \
    -m dynam3d_torch.run --run-type train --trainer SS-ETP --exp_name "$EXP" "$@"
