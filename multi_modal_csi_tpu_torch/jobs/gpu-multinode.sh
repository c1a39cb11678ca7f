#!/bin/bash
# Multi-node launcher for the port: the counterpart of the JAX package's
# jobs/tpu-multihost-jobset.yaml. One copy of this script runs on each
# node and starts one torchrun agent there (python3 -m torch.distributed.run).
# The agents meet at a c10d rendezvous on MASTER_ADDR:MASTER_PORT and each
# starts NPROC_PER_NODE ranks, one a card (the card of the rank's
# LOCAL_RANK: parallel/mesh.py::local_device), running JAX's command:
# cli/run_csi.py --distributed --mesh --set mesh.fsdp=true, FSDP2 over
# every rank of every node.
#
# Under SLURM, submit it with sbatch (4 nodes of 8 cards below): the batch
# step reads NNODES from SLURM_NNODES, NPROC_PER_NODE from
# SLURM_GPUS_ON_NODE, RDZV_ID from SLURM_JOB_ID and MASTER_ADDR, the first
# host of the job's node list, from scontrol, then runs this script once on
# each node through srun. Elsewhere (gpu-multinode-jobset.yaml, a shell)
# the same variables come from the environment, and a missing one is
# refused by name; MASTER_PORT defaults to 29500.
#
# Nothing is staged to node-local disk: every node must see the code (this
# checkout, put first on PYTHONPATH) and DATA_PATH at the same paths, as
# JAX's pods mount one volume. Only global rank 0 prints the result and
# writes path.save (relative to the working directory), and under the c10d
# rendezvous the node that holds rank 0 is not fixed: point path.save at a
# directory every node shares.
#
# A rank that fails stops every rank, and torchrun starts them all again,
# at most MAX_RESTARTS times (3, JAX's failurePolicy.maxRestarts). A
# restart reruns the experiment from its start: no CLI reads a checkpoint
# directory, in the JAX package or in the port.
#
# Arguments after the script's name pass on to run_csi; a later --set
# overrides an earlier one (e.g. --set path.save=/shared/result.json,
# --device cpu for gloo on the CPU). DRY_RUN=1 prints this node's command
# on one line starting "DRY " and runs nothing; DATA_PATH stays required.
#SBATCH --nodes=4
#SBATCH --ntasks-per-node=1
#SBATCH --gres=gpu:8
#SBATCH --time=24:00:00
#SBATCH --output=logs/%x-%j.out

set -euo pipefail

DRY=${DRY_RUN:-0}
RUN=""
if [ "$DRY" = "1" ]; then RUN="echo DRY"; fi

# DATA_PATH must point at the WiMANS dataset root, on every node
export DATA_PATH=${DATA_PATH:?set DATA_PATH to the dataset root}

# the checkout this script lies in; sbatch runs a copy of the script from
# its spool directory, and then the checkout is where sbatch was called
SRC=$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)
if [ ! -d "$SRC/multi_modal_csi_tpu_torch" ]; then
  SRC=${SLURM_SUBMIT_DIR:?submit this script from the root of its checkout}
fi

if [ -n "${SLURM_JOB_ID:-}" ] && [ -z "${MMCSI_NODE_STEP:-}" ]; then
  # the batch step: SLURM's allocation names the rendezvous
  export NNODES=$SLURM_NNODES
  export NPROC_PER_NODE=$SLURM_GPUS_ON_NODE
  export RDZV_ID=$SLURM_JOB_ID
  MASTER_ADDR=$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n 1)
  export MASTER_ADDR
  if [ "$DRY" != "1" ]; then
    export MMCSI_NODE_STEP=1
    exec srun --ntasks-per-node=1 --nodes="$NNODES" \
        bash "$SRC/multi_modal_csi_tpu_torch/jobs/gpu-multinode.sh" "$@"
  fi
fi

NNODES=${NNODES:?set NNODES to the number of nodes}
NPROC_PER_NODE=${NPROC_PER_NODE:?set NPROC_PER_NODE to the ranks (cards) a node}
MASTER_ADDR=${MASTER_ADDR:?set MASTER_ADDR to the rendezvous host}
RDZV_ID=${RDZV_ID:?set RDZV_ID to an id the job shares on every node}
MASTER_PORT=${MASTER_PORT:-29500}

# experiment knobs (the reference's config_modifier.py set, read by
# core/config.py::apply_env_overrides in every rank)
export MODEL_TYPE=${MODEL_TYPE:-DETR}
export LEARNING_RATE=${LEARNING_RATE:-5e-4}
export BATCH_SIZE=${BATCH_SIZE:-16}
export NUM_EPOCHS=${NUM_EPOCHS:-300}
export AUX_LOSS=${AUX_LOSS:-0.25}
export ENVIRONMENTS_EXP=${ENVIRONMENTS_EXP:-empty_room}

export PYTHONPATH="$SRC${PYTHONPATH:+:$PYTHONPATH}"

$RUN python3 -m torch.distributed.run \
    --nnodes "$NNODES" --nproc-per-node "$NPROC_PER_NODE" \
    --rdzv-backend c10d --rdzv-endpoint "$MASTER_ADDR:$MASTER_PORT" \
    --rdzv-id "$RDZV_ID" --max-restarts "${MAX_RESTARTS:-3}" \
    -m multi_modal_csi_tpu_torch.cli.run_csi \
    --model "$MODEL_TYPE" --task "${TASK:-activity}" \
    --distributed --mesh \
    --set mesh.fsdp=true \
    --set path.data_x="$DATA_PATH/wifi_csi/amp" \
    --set path.data_y="$DATA_PATH/annotation.csv" "$@"
