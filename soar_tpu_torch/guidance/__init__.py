"""Port of ``soar_tpu.guidance``: the SDS step (schedule, multi-view
guidance, the 4-view diffusion UNet, the VAE encoder and ``build_guidance``),
ImageDream's image prompt (the CLIP ViT tower and the Resampler), the
checkpoints' key manifests and the prompt embeddings."""
