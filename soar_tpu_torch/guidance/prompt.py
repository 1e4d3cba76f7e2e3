"""Prompt processing: text -> the (cond, uncond) embeddings the guidance
reads (port of ``soar_tpu.guidance.prompt``).

Replaces threestudio's ``stable-diffusion-prompt-processor``
(``configs/gaussiansurfel_imagedream_s0.yaml:81-85``): the prompt and the
long negative prompt through SD2.1's OpenCLIP-H text encoder, stacked to
[2, 77, 1024].  Backends, in order:

1. a ``.npz`` of precomputed embeddings (keys ``cond`` and ``uncond``,
   each [77, D]);
2. ``transformers``' ``CLIPTextModel`` from a local model directory, only
   when ``transformers`` is importable and the directory exists.

Nothing is downloaded: without either the call raises
``FileNotFoundError``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

NEGATIVE_PROMPT = (
    "ugly, bad anatomy, blurry, pixelated obscure, unnatural colors, poor "
    "lighting, dull, and unclear, cropped, lowres, low quality, artifacts, "
    "duplicate, morbid, mutilated, poorly drawn face, deformed, dehydrated, "
    "bad proportions, unfocused"
)  # (``configs/gaussiansurfel_imagedream_s0.yaml:84``)


@dataclasses.dataclass
class PromptProcessor:
    prompt: str
    negative_prompt: str = NEGATIVE_PROMPT
    embeddings_path: Optional[str] = None  # precomputed .npz
    clip_model_dir: Optional[str] = None  # local transformers checkpoint

    def __call__(self) -> np.ndarray:
        """Returns [2, 77, D] float32: (cond, uncond) text embeddings."""
        if self.embeddings_path and os.path.exists(self.embeddings_path):
            data = np.load(self.embeddings_path)
            return np.stack([data["cond"], data["uncond"]]).astype(np.float32)
        if self.clip_model_dir and os.path.exists(self.clip_model_dir) and _has_transformers():
            return self._encode_with_transformers()
        raise FileNotFoundError(
            "prompt embeddings unavailable: supply --embeddings-path (a .npz "
            "with cond/uncond [77, D] arrays, precomputed with any CLIP) or "
            "--clip-model-dir (a local stabilityai/stable-diffusion-2-1-base "
            "text_encoder+tokenizer directory). This environment cannot "
            "download models."
        )

    def _encode_with_transformers(self) -> np.ndarray:
        import torch
        from transformers import CLIPTextModel, CLIPTokenizer

        tok = CLIPTokenizer.from_pretrained(self.clip_model_dir)
        enc = CLIPTextModel.from_pretrained(self.clip_model_dir).eval()
        outs = []
        with torch.no_grad():
            for text in (self.prompt, self.negative_prompt):
                ids = tok(text, padding="max_length", max_length=77, truncation=True,
                          return_tensors="pt")
                outs.append(enc(ids.input_ids).last_hidden_state[0].numpy().astype(np.float32))
        return np.stack(outs)


def _has_transformers() -> bool:
    import importlib.util

    return importlib.util.find_spec("transformers") is not None
