#!/bin/bash
# Train the port's flagship artifacts on the card, gate them, and drill them
# (docs/DAYONE_torch.md §0). runs/ is git-ignored: a fresh clone has none.
#
#   runs/torch/proposal_video448/mrcnn.msgpack  proposal Mask R-CNN (256x448,
#                                               R-18, 4 classes, video domain)
#   runs/torch/dmm448/dmm.msgpack               flagship DMM (256x448, R-50,
#                                               tapered decoder
#                                               obj_dim_fine=16)
#
# Both are the JAX package's flax msgpack formats, so either package serves
# them; they stay under runs/torch/ so that port-trained weights are never
# taken for the JAX package's (runs/dmm448/, runs/proposal_video448/).
#
# The four stages, knobs and gates of tools/regen_artifacts.sh, on the
# port's entry points. Knobs (environment), with their defaults:
#   MRCNN_STEPS=4000 DMM_STEPS=4000       training depth of the two stages
#   DMM_MIN_JF=0.90                       the DMM's held-out J&F at save time
#   SYS_MIN_JF=0.85                       the full system's J&F
# The full system's recall (>= 0.9) and the drill's J&F (> 0.90) are fixed.
set -e
cd "$(dirname "$0")/.."
mkdir -p runs/torch/dmm448 runs/torch/proposal_video448

# The detector first: the DMM trains on its detections (the reference's
# protocol; a DMM trained on planted proposals alone collapses on a
# detector's soft-edged masks).
python3 train_proposal_torch.py --data video --image-size 256 448 \
  --backbone resnet18 --num-classes 4 --steps "${MRCNN_STEPS:-4000}" \
  --batch 2 --logdir runs/torch/proposal_video448 \
  --save runs/torch/proposal_video448/mrcnn.msgpack

# The DMM on the detector's proposals. The held-out evaluation gates the
# file: it is written as dmm.msgpack.unverified and renamed only at or
# above --min-jf.
python3 examples/train_and_eval_synthetic_torch.py --size 256 --width 448 \
  --backbone resnet50 --feature-dim 64 --decoder-dim 64 --obj-dim 32 \
  --steps "${DMM_STEPS:-4000}" --set model.decoder_obj_dim_fine=16 \
  --mrcnn runs/torch/proposal_video448/mrcnn.msgpack --mrcnn-classes 4 \
  --eval-seqs 2 --min-jf "${DMM_MIN_JF:-0.90}" \
  --save runs/torch/dmm448/dmm.msgpack

# The full system on held-out videos: exits non-zero below its floors.
python3 examples/full_system_synthetic_torch.py \
  --dmm runs/torch/dmm448/dmm.msgpack \
  --mrcnn runs/torch/proposal_video448/mrcnn.msgpack --mrcnn-classes 4 \
  --eval-seqs 6 --frames 6 --min-jf "${SYS_MIN_JF:-0.85}" \
  --min-recall 0.9

# The drill on the files just written; REQUIRE_ARTIFACTS turns its skip on
# missing files into a failure. --noconftest: tests/conftest.py sets up JAX,
# which the card's machine does not have (the file's JAX tests skip there).
REQUIRE_ARTIFACTS=1 python3 -m pytest tests/test_torch_port_dayone.py -q --noconftest \
  -p no:cacheprovider
