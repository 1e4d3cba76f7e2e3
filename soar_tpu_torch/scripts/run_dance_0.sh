#!/bin/bash
# Two-stage SOAR training of the dance_0 sequence with soar_tpu_torch: the
# sequence of scripts/run_dance_0.sh (stage 0, then stage 1 resumed from
# stage 0's checkpoint with the eval), run by soar_tpu_torch.cli.train.
#
# ImageDream SDS guidance needs weights that are not in the repository:
#   GUIDANCE_CKPT=/path/to/sd-v2.1-base-4view-ipmv.pt   (torch checkpoint)
#   PROMPT_EMBEDDINGS=/path/to/prompt.npz  (or CLIP_MODEL_DIR=...)
# With GUIDANCE_CKPT unset, MOCK_GUIDANCE=1 runs random full-shape networks
# (timing and smoke runs), and otherwise SDS is skipped (reconstruction
# only).  SMPL_MODEL overrides the body model file.
set -e
seq="dance_0"
prompt="A man with a T-shirt, black pants, and black sneakers."
smpl_model="${SMPL_MODEL:-data/smpl_related/models/smplx/SMPLX_NEUTRAL.npz}"

guidance_args=()
if [[ -n "${GUIDANCE_CKPT:-}" ]]; then
    guidance_args+=(--guidance imagedream --prompt "$prompt"
                    --guidance-ckpt "$GUIDANCE_CKPT")
    [[ -n "${PROMPT_EMBEDDINGS:-}" ]] && guidance_args+=(--prompt-embeddings "$PROMPT_EMBEDDINGS")
    [[ -n "${CLIP_MODEL_DIR:-}" ]] && guidance_args+=(--clip-model-dir "$CLIP_MODEL_DIR")
elif [[ -n "${MOCK_GUIDANCE:-}" ]]; then
    guidance_args+=(--guidance imagedream --prompt "$prompt" --mock-guidance)
fi

echo "Running Stage 0"
python -m soar_tpu_torch.cli.train \
    --dataroot "data/custom/$seq" \
    --smpl-model "$smpl_model" \
    --out "outputs/$seq" \
    --stage 0 --steps 1000 \
    "${guidance_args[@]}"

echo "Running Stage 1"
python -m soar_tpu_torch.cli.train \
    --dataroot "data/custom/$seq" \
    --smpl-model "$smpl_model" \
    --out "outputs/$seq" \
    --stage 1 --steps 1000 \
    --resume "outputs/$seq/stage0" \
    --eval \
    "${guidance_args[@]}"
