"""SOCRATES radiative-transfer interface (re-export of the scheme).

Port of isca_tpu/physics/socrates_interface.py. The reference vendors only
the adapter around the UK Met Office SOCRATES radiance core
(src/atmos_param/socrates/interface/*.F90; the core is supplied externally
via $GFDL_SOC, codebase.py:315-344). `physics/socrates.py` holds the port's
spectral-file-driven correlated-k two-stream solver; this module keeps the
historical import location:

    from isca_tpu_torch.physics.socrates_interface import SocratesConfig, SocratesRadiation
"""

from isca_tpu_torch.physics.socrates import SocratesConfig, SocratesRadiation

__all__ = ["SocratesConfig", "SocratesRadiation"]
