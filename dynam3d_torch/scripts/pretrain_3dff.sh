#!/usr/bin/env bash
# 3DFF pretraining (run_3dff/3dff.bash equivalent).  One rank: the port
# refuses SS-ETP training at NPROC > 1 (its dispatcher draws a dataset per
# rank; ROADMAP Queue 1, item 9).
set -euo pipefail
EXP=${1:-3dff_exp}
shift || true
python -m torch.distributed.run --standalone --nproc_per_node="${NPROC:-1}" \
    -m dynam3d_torch.run --run-type train --trainer SS-ETP --exp_name "$EXP" "$@"
