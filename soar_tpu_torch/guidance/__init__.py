"""Port of ``soar_tpu.guidance``: the SDS step (schedule, multi-view
guidance, the 4-view diffusion UNet, the VAE encoder and ``build_guidance``).
The image prompt's CLIP tower and Resampler arrive with a later slice."""
