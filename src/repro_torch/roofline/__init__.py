"""The port's analytic roofline: closed-form FLOP and byte models
(``analytic``) and the three-term report (``analysis``) with the H100's
datasheet constants."""
