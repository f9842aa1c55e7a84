"""Models: Grounding-DINO, CLIP, SAM and their shared layers."""
