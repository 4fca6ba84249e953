"""Measurement entry points of the port, run on the card:

    python -m versatiles_glyphs_tpu_torch.tools.roofline
    python -m versatiles_glyphs_tpu_torch.tools.kernel_ab
    python -m versatiles_glyphs_tpu_torch.tools.kernel_turns --kernel NAME --variant ...
    python -m versatiles_glyphs_tpu_torch.tools.session_turns
    python -m versatiles_glyphs_tpu_torch.tools.profile

and the port's lint and compile check, run anywhere:

    python -m versatiles_glyphs_tpu_torch.tools.check

`work` holds the work counts and bounds they and ``chip_smoke.py`` share.
"""
