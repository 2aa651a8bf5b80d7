"""Modality frontend stubs for the audio and VLM families (a copy of
``repro.data.modality_stubs``, numpy only).

The mel-spectrogram + conv feature extractor (whisper) and the ViT vision
encoder + projector (qwen2-vl) are not implemented; these helpers produce
precomputed frame / patch embeddings of the shape the language / decoder
transformer consumes.
"""
from __future__ import annotations

import numpy as np


def audio_frame_embeddings(
    rng: np.random.Generator, batch: int, frames: int, d_model: int
) -> np.ndarray:
    """Whisper-style encoder input: (batch, frames, d_model) float32 --
    stands in for conv1/conv2(mel) output (frames = samples/320)."""
    t = np.linspace(0, 1, frames)[None, :, None]
    base = np.sin(2 * np.pi * (1 + np.arange(d_model)[None, None, :] % 7) * t)
    noise = rng.normal(0, 0.1, (batch, frames, d_model))
    return (0.5 * base + noise).astype(np.float32)


def vision_patch_embeddings(
    rng: np.random.Generator, batch: int, patches: int, d_model: int
) -> np.ndarray:
    """Qwen2-VL-style projected vision tokens: (batch, patches, d_model) --
    stands in for ViT(dynamic-resolution image) + MLP projector output."""
    return rng.normal(0, 1.0, (batch, patches, d_model)).astype(np.float32)
