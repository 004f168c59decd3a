"""Physical constants and unit helpers.

As in the reference, the only constant the compute path uses is the hc
product in eV*nm (``lmbda_nm = 1240. / energy_ev``).
"""

import math

PI = math.pi

#: hc in eV*nm, rounded as in the reference (1240, not 1239.84).
HC_EV_NM = 1240.0


def wavelength_nm(energy_ev: float) -> float:
    """X-ray wavelength in nm for a photon energy in eV."""
    return HC_EV_NM / energy_ev
