"""Measurement entry points of the port, run on the card:

    python -m versatiles_glyphs_tpu_torch.tools.roofline
    python -m versatiles_glyphs_tpu_torch.tools.kernel_ab

`work` holds the work counts and bounds they and ``chip_smoke.py`` share.
"""
