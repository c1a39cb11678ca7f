#!/bin/bash
# Sweep: models x user sets through the port's CSI CLI (the
# reference's wifi_csi/run.sh:1-35 loop, without the conda plumbing), each
# experiment trained on the card.
set -euo pipefail

MODELS=${MODELS:-"MLP LSTM CNN-1D CNN-2D CLSTM ABLSTM THAT DETR"}
USER_SETS=${USER_SETS:-"0,1,2,3,4,5"}
TASK=${TASK:-activity}
# DRY_RUN=1: print each experiment command instead of running it
RUN=""
if [ "${DRY_RUN:-0}" = "1" ]; then RUN="echo DRY"; fi

for model in $MODELS; do
  for users in $USER_SETS; do
    echo "=== $model users=$users ==="
    $RUN python -m multi_modal_csi_tpu_torch.cli.run_csi \
        --model "$model" --task "$TASK" --users "$users" \
        --set "path.save=results/result_${model}_${users//,/}.json"
  done
done
