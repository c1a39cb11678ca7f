#!/bin/bash
# One-H100 job launcher for the port: the reference's SLURM script
# (cc-job.sh:1-59): stage the code, apply the env-var config overlay, run
# the experiment on the card, collect the results. Runs as-is outside
# SLURM (the #SBATCH lines are comments there).
#SBATCH --nodes=1
#SBATCH --gres=gpu:1
#SBATCH --time=24:00:00
#SBATCH --output=logs/%x-%j.out

set -euo pipefail

# DRY_RUN=1: skip staging and echo the experiment command instead of
# running it. DATA_PATH stays required even in dry runs: forgetting it is
# the launch error this guard exists for.
DRY=${DRY_RUN:-0}
RUN=""
if [ "$DRY" = "1" ]; then RUN="echo DRY"; fi

SRC=${SRC:-$(pwd)}
RESULTS=${RESULTS:-$SRC/results}

if [ "$DRY" != "1" ]; then
  # WORKDIR only exists on real runs: a dry run must not leave a mktemp
  # directory behind
  WORKDIR=${SLURM_TMPDIR:-$(mktemp -d)}
  echo "staging $SRC -> $WORKDIR"
  rsync -a --exclude results --exclude .git "$SRC/" "$WORKDIR/"
  cd "$WORKDIR"
fi

# experiment knobs (the reference's config_modifier.py set, read by
# core/config.py::apply_env_overrides in-process)
export MODEL_TYPE=${MODEL_TYPE:-DETR}
export LEARNING_RATE=${LEARNING_RATE:-5e-4}
export BATCH_SIZE=${BATCH_SIZE:-16}
export NUM_EPOCHS=${NUM_EPOCHS:-300}
export AUX_LOSS=${AUX_LOSS:-0.25}
export ENVIRONMENTS_EXP=${ENVIRONMENTS_EXP:-empty_room}
# DATA_PATH must point at the WiMANS dataset root
export DATA_PATH=${DATA_PATH:?set DATA_PATH to the dataset root}

if [ "$DRY" != "1" ]; then mkdir -p results; fi
$RUN python -m multi_modal_csi_tpu_torch.cli.run_csi \
    --model "$MODEL_TYPE" --task "${TASK:-activity}" \
    --repeat "${REPEAT:-8}"

if [ "$DRY" != "1" ]; then
  mkdir -p "$RESULTS"
  rsync -a results/ "$RESULTS/"
  echo "results copied to $RESULTS"
fi
