"""Contrastive training of the CLIP dual encoder (``clip_tuner.CLIPTuner``)."""
