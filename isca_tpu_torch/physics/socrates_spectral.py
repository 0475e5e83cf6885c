"""SOCRATES spectral files: data model, reader/writer, synthetic spectra.

The port's own copy of isca_tpu/physics/socrates_spectral.py (pure numpy;
the port imports nothing of isca_tpu). The reference vendors only the
*interface* to the UK Met Office SOCRATES radiance core
(src/atmos_param/socrates/interface/*, codebase.py:315-344 — the core itself
is external source symlinked at build via $GFDL_SOC, and its correlated-k
data live in separately distributed "spectral files"). This module is the
spectral-file layer of the port's SOCRATES scheme:

  * ``SpectrumData`` — plain-numpy container for everything the GCM-mode
    solver needs: band limits, solar fractions, Rayleigh coefficients,
    ESFT/correlated-k gas fits with pressure/temperature scaling, Planck
    polynomial thermal source, H2O continuum, and Slingo-type droplet / ice
    parametrizations.
  * ``read_spectral_file`` / ``write_spectral_file`` — the Met Office
    plain-text block format (``*BLOCK: TYPE = n`` ... ``*END``).  The reader
    is tolerant of spacing/width differences and covers the blocks used in
    GCM mode (0,1,2,3,4,5,6,8,9,10,12); exotic blocks are skipped.
  * ``synthetic_sw_spectrum`` / ``synthetic_lw_spectrum`` — physically
    plausible 6-band SW / 9-band LW spectra (ga7-like band structure,
    Planck-weighted solar fractions, lambda^-4 Rayleigh, Hartley/Chappuis
    ozone, H2O rotation band + window continuum + CO2 15um), the default of
    SocratesConfig.

Band gas lists and ESFT fits keep insertion order (Python lists and dicts),
which fixes the g-point order of the SOCRATES solver.

Gas identifiers follow SOCRATES rad_pcf: 1=H2O 2=CO2 3=O3 4=N2O 5=CO 6=CH4
7=O2 9=SO2 14=CFC11 15=CFC12.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

# SOCRATES rad_pcf gas indices (subset)
IP_H2O, IP_CO2, IP_O3, IP_N2O, IP_CO, IP_CH4, IP_O2 = 1, 2, 3, 4, 5, 6, 7
IP_SO2, IP_CFC11, IP_CFC12 = 9, 14, 15

GAS_NAMES = {
    IP_H2O: "Water Vapour", IP_CO2: "Carbon Dioxide", IP_O3: "Ozone",
    IP_N2O: "Dinitrogen Oxide", IP_CO: "Carbon monoxide", IP_CH4: "Methane",
    IP_O2: "Oxygen", IP_SO2: "Sulphur dioxide", IP_CFC11: "CFC11",
    IP_CFC12: "CFC12",
}

# molar masses [kg/mol] for vmr<->mmr conversions in the adapter
MOLAR_MASS = {
    IP_H2O: 18.0153e-3, IP_CO2: 44.0095e-3, IP_O3: 47.9982e-3,
    IP_N2O: 44.0128e-3, IP_CO: 28.0101e-3, IP_CH4: 16.0425e-3,
    IP_O2: 31.9988e-3, IP_SO2: 64.064e-3, IP_CFC11: 137.3686e-3,
    IP_CFC12: 120.9140e-3,
}
MOLAR_MASS_AIR = 28.966e-3

# scaling function types (rad_pcf IP_scale_fnc_*)
SCALE_NULL = 0          # k constant
SCALE_POWER_LAW = 1     # k * (p/p0)^a * (T/T0)^b
SCALE_POWER_QUAD = 2    # k * (p/p0)^a * (1 + c (T/T0-1) + d (T/T0-1)^2)


@dataclasses.dataclass
class GasFit:
    """ESFT/correlated-k fit for one gas in one band (spectral block 5).

    Transmission over absorber path u [kg/m2]:
        T(u) = sum_i w[i] * exp(-k[i] * f(p, T) * u)
    with f the scaling function (SCALE_*) about (p_ref, t_ref).
    """
    gas: int                  # absorber identifier (rad_pcf)
    k: np.ndarray             # (nk,) [m2/kg] at reference conditions
    w: np.ndarray             # (nk,) weights, sum = 1
    scale_fnc: int = SCALE_POWER_LAW
    p_ref: float = 5.0e4      # [Pa]
    t_ref: float = 250.0      # [K]
    scale: tuple = (0.8, 0.5)  # scaling params (a, b[, c, d])


@dataclasses.dataclass
class Continuum:
    """H2O self/foreign continuum in one band (blocks 8+9).

    tau = k * u_h2o * (e/p_ref_c)^alpha * (t_ref_c/T)^beta with e the H2O
    partial pressure (self) or dry pressure (foreign).
    """
    k: float                  # [m2/kg]
    self_broadened: bool = True
    p_ref_c: float = 1.0e3    # [Pa]
    t_ref_c: float = 296.0
    alpha: float = 1.0
    beta: float = 4.0


@dataclasses.dataclass
class SpectrumData:
    """Everything the GCM-mode two-stream solver consumes."""
    name: str
    is_sw: bool
    wl_short: np.ndarray            # (nb,) band lower wavelength [m]
    wl_long: np.ndarray             # (nb,)
    absorbers: list                 # gas identifiers present in the file
    band_gases: list                # per band: list of absorber ids (major first)
    esft: dict                      # (band, gas) -> GasFit
    solar_frac: np.ndarray | None = None     # (nb,) normalized solar flux
    rayleigh: np.ndarray | None = None       # (nb,) [m2/kg of air]
    planck: np.ndarray | None = None         # (nb, deg+1) polynomial coeffs
    t_ref_planck: float = 255.0
    continuum: dict = dataclasses.field(default_factory=dict)  # band -> [Continuum]
    # Slingo-type parametrizations: tau = cwp*(a + b/re); 1-ssa = c + d*re;
    # g = e + f*re   (cwp [g/m2], re [um]; LW uses only (a, b) as absorption)
    drop_coeffs: np.ndarray | None = None    # (nb, 6)
    ice_coeffs: np.ndarray | None = None     # (nb, 6)

    @property
    def n_band(self):
        return len(self.wl_short)


# ---------------------------------------------------------------------------
# Planck helpers (used for synthetic thermal-source fits and tests)
# ---------------------------------------------------------------------------

_H, _C, _KB = 6.62607015e-34, 2.99792458e8, 1.380649e-23


def band_planck_flux(wl_lo, wl_hi, T, n_quad=64):
    """pi * integral of the Planck spectral radiance over [wl_lo, wl_hi]
    [W/m2]; T may be an array."""
    T = np.atleast_1d(np.asarray(T, np.float64))
    # integrate in log-lambda for stability across decades
    x = np.linspace(np.log(wl_lo), np.log(wl_hi), n_quad)
    lam = np.exp(x)
    B = (2.0 * _H * _C**2 / lam[None, :]**5
         / np.expm1(_H * _C / (lam[None, :] * _KB * T[:, None])))
    trapezoid = getattr(np, "trapezoid", None) or np.trapz   # numpy < 2 names it trapz
    out = np.pi * trapezoid(B * lam[None, :], x, axis=1)
    return out if out.size > 1 else float(out[0])


def fit_planck_polynomial(wl_short, wl_long, t_ref=255.0, degree=5,
                          t_range=(120.0, 360.0)):
    """Least-squares fit B_band(T) = sum_j c_j (T/t_ref)^j per band."""
    T = np.linspace(*t_range, 60)
    nb = len(wl_short)
    coeffs = np.zeros((nb, degree + 1))
    x = T / t_ref
    A = np.stack([x**j for j in range(degree + 1)], axis=1)
    for b in range(nb):
        y = band_planck_flux(wl_short[b], wl_long[b], T)
        coeffs[b] = np.linalg.lstsq(A, y, rcond=None)[0]
    return coeffs


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

def _fmt(x):
    return f"{x: .9E}"


def write_spectral_file(spec: SpectrumData, path):
    """Write in the Met Office spectral-file block layout."""
    L = []
    nb = spec.n_band
    L.append("*BLOCK: TYPE =    0: SUBTYPE =    0: VERSION =    2")
    L.append("Summary of spectral data.")
    L.append(f"Number of spectral bands = {nb:5d}")
    L.append(f"Total number of gaseous absorbers = {len(spec.absorbers):5d}")
    L.append("List of indexing numbers and absorbers.")
    L.append("Index       Absorber(identifier and name)")
    for i, g in enumerate(spec.absorbers):
        L.append(f"{i + 1:5d}      {g:4d}       {GAS_NAMES.get(g, 'Gas'):<20s}")
    L.append("*END")

    L.append("*BLOCK: TYPE =    1: SUBTYPE =    0: VERSION =    0")
    L.append("Specification of spectral intervals")
    L.append("Limits of spectral intervals in the units of metres.")
    L.append("Band        Lower limit         Upper limit")
    for b in range(nb):
        L.append(f"{b + 1:5d}   {_fmt(spec.wl_short[b])}   {_fmt(spec.wl_long[b])}")
    L.append("*END")

    if spec.solar_frac is not None:
        L.append("*BLOCK: TYPE =    2: SUBTYPE =    0: VERSION =    0")
        L.append("Normalized solar flux in each spectral interval.")
        L.append("Band        Normalized flux")
        for b in range(nb):
            L.append(f"{b + 1:5d}   {_fmt(spec.solar_frac[b])}")
        L.append("*END")

    if spec.rayleigh is not None:
        L.append("*BLOCK: TYPE =    3: SUBTYPE =    0: VERSION =    0")
        L.append("Rayleigh scattering coefficients in each interval.")
        L.append("Band        Rayleigh coefficient (m2/kg)")
        for b in range(nb):
            L.append(f"{b + 1:5d}   {_fmt(spec.rayleigh[b])}")
        L.append("*END")

    L.append("*BLOCK: TYPE =    4: SUBTYPE =    0: VERSION =    0")
    L.append("Gaseous absorbers in each interval")
    L.append("(The number of absorbers and the indexing numbers of each absorber)")
    for b in range(nb):
        gases = spec.band_gases[b]
        idx = [spec.absorbers.index(g) + 1 for g in gases]
        L.append(f"Band = {b + 1:5d}    Number of absorbers = {len(gases):5d}")
        L.append("".join(f"{i:5d}" for i in idx) if idx else "")
    L.append("*END")

    L.append("*BLOCK: TYPE =    5: SUBTYPE =    0: VERSION =    1")
    L.append("Exponential sum fitting coefficients: (exponents: m2/kg)")
    for (b, gas), fit in sorted(spec.esft.items()):
        idx = spec.absorbers.index(gas) + 1
        L.append(f"Band = {b + 1:5d}    Gas = {idx:5d}")
        L.append(f"Number of k-terms = {len(fit.k):5d}")
        L.append(f"Scaling function = {fit.scale_fnc:5d}")
        L.append(f"Reference pressure = {_fmt(fit.p_ref)}    "
                 f"Reference temperature = {_fmt(fit.t_ref)}")
        for i in range(len(fit.k)):
            row = f"   {_fmt(fit.k[i])}   {_fmt(fit.w[i])}"
            if fit.scale_fnc != SCALE_NULL:
                row += "".join(f"   {_fmt(s)}" for s in fit.scale)
            L.append(row)
    L.append("*END")

    if spec.planck is not None:
        deg = spec.planck.shape[1] - 1
        L.append("*BLOCK: TYPE =    6: SUBTYPE =    0: VERSION =    0")
        L.append("Thermal source function.")
        L.append(f"Degree of polynomial fit = {deg:5d}    "
                 f"Reference temperature = {_fmt(spec.t_ref_planck)}")
        for b in range(nb):
            L.append(f"Band = {b + 1:5d}")
            for j in range(deg + 1):
                L.append(f"   {_fmt(spec.planck[b, j])}")
        L.append("*END")

    if spec.continuum:
        L.append("*BLOCK: TYPE =    9: SUBTYPE =    0: VERSION =    0")
        L.append("Continuum absorption coefficients.")
        for b, conts in sorted(spec.continuum.items()):
            for c in conts:
                L.append(f"Band = {b + 1:5d}    Continuum type = "
                         f"{1 if c.self_broadened else 2:5d}")
                L.append(f"   {_fmt(c.k)}   {_fmt(c.p_ref_c)}   "
                         f"{_fmt(c.t_ref_c)}   {_fmt(c.alpha)}   {_fmt(c.beta)}")
        L.append("*END")

    for btype, coeffs, label in ((10, spec.drop_coeffs, "droplets"),
                                 (12, spec.ice_coeffs, "ice crystals")):
        if coeffs is None:
            continue
        L.append(f"*BLOCK: TYPE =   {btype}: SUBTYPE =    0: VERSION =    2")
        L.append(f"Parametrized scattering data for {label}.")
        L.append("Parametrization scheme = 1 (Slingo)")
        for b in range(nb):
            L.append(f"Band = {b + 1:5d}")
            L.append("".join(f"   {_fmt(c)}" for c in coeffs[b]))
        L.append("*END")

    with open(path, "w") as f:
        f.write("\n".join(L) + "\n")


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

_FLOAT = re.compile(r"[-+]?\d+\.?\d*(?:[EeDd][-+]?\d+)?")


def _floats(line):
    return [float(t.replace("D", "E").replace("d", "e"))
            for t in _FLOAT.findall(line)]


def _is_data_row(line):
    """True if the line is numbers only (exponent letters excepted)."""
    return not re.search(r"[A-Za-z]", _FLOAT.sub("", line))


def _split_blocks(text):
    blocks = []
    cur, btype = None, None
    for line in text.splitlines():
        m = re.match(r"\*BLOCK:\s*TYPE\s*=\s*(\d+)", line)
        if m:
            btype, cur = int(m.group(1)), []
            continue
        if line.startswith("*END"):
            if btype is not None:
                blocks.append((btype, cur))
            btype, cur = None, None
            continue
        if cur is not None:
            cur.append(line)
    return blocks


def read_spectral_file(path, name=None) -> SpectrumData:
    """Parse a SOCRATES spectral file (GCM-mode blocks; others skipped)."""
    with open(path) as f:
        text = f.read()
    blocks = _split_blocks(text)

    absorbers, nb = [], 0
    wl_short = wl_long = solar = rayleigh = planck = None
    t_ref_planck = 255.0
    band_gases, esft, continuum = [], {}, {}
    drop = ice = None

    for btype, lines in blocks:
        if btype == 0:
            for ln in lines:
                m = re.search(r"Number of spectral bands\s*=\s*(\d+)", ln)
                if m:
                    nb = int(m.group(1))
                m = re.match(r"\s*(\d+)\s+(\d+)\s+\S", ln)
                if m:
                    absorbers.append(int(m.group(2)))
        elif btype == 1:
            rows = [_floats(ln) for ln in lines
                    if re.match(r"\s*\d+\s+[-+\d]", ln)]
            rows = [r for r in rows if len(r) >= 3]
            wl_short = np.array([r[1] for r in rows])
            wl_long = np.array([r[2] for r in rows])
        elif btype == 2:
            rows = [_floats(ln) for ln in lines if re.match(r"\s*\d+\s", ln)]
            solar = np.array([r[1] for r in rows if len(r) >= 2])
        elif btype == 3:
            rows = [_floats(ln) for ln in lines if re.match(r"\s*\d+\s", ln)]
            rayleigh = np.array([r[1] for r in rows if len(r) >= 2])
        elif btype == 4:
            band_gases = [[] for _ in range(nb)]
            b = None
            for ln in lines:
                m = re.search(r"Band\s*=\s*(\d+)", ln)
                if m:
                    b = int(m.group(1)) - 1
                    continue
                if b is not None and ln.strip():
                    idx = [int(t) for t in re.findall(r"\d+", ln)]
                    band_gases[b] = [absorbers[i - 1] for i in idx]
                    b = None
        elif btype == 5:
            key, fit_rows, meta = None, [], {}
            def flush():
                if key is not None and fit_rows:
                    arr = np.array(fit_rows)
                    # UKMO files (sp_*_ga7 et al.) carry a leading k-term
                    # INDEX column (1..n); our writer does not. Detect and
                    # drop it: first column integral, consecutive from 1.
                    if (arr.shape[1] >= 3
                            and np.all(arr[:, 0] == np.round(arr[:, 0]))
                            and np.array_equal(arr[:, 0],
                                               np.arange(1, len(arr) + 1))):
                        arr = arr[:, 1:]
                    esft[key] = GasFit(
                        gas=key[1], k=arr[:, 0].copy(), w=arr[:, 1].copy(),
                        scale_fnc=meta.get("fnc", SCALE_POWER_LAW),
                        p_ref=meta.get("p", 5.0e4), t_ref=meta.get("t", 250.0),
                        scale=tuple(arr[0, 2:]) if arr.shape[1] > 2 else ())
            for ln in lines:
                m = re.search(r"Band\s*=\s*(\d+)\s*.*Gas\s*=\s*(\d+)", ln,
                              re.IGNORECASE)
                if m:
                    flush()
                    key = (int(m.group(1)) - 1,
                           absorbers[int(m.group(2)) - 1])
                    fit_rows, meta = [], {}
                    continue
                # "Scaling function = 2" (our writer) or the UKMO wordings
                # "Type of scaling = 2" / "Type of scaling function = 2"
                m = re.search(r"(?:scaling(?:\s+function)?|type of scaling"
                              r"(?:\s+function)?)\s*=\s*(\d+)", ln,
                              re.IGNORECASE)
                if m:
                    meta["fnc"] = int(m.group(1))
                    continue
                m = re.search(r"Reference pressure\s*=\s*(\S+)\s*.*"
                              r"Reference temperature\s*=\s*(\S+)", ln,
                              re.IGNORECASE)
                if m:
                    meta["p"] = _floats(m.group(1))[0]
                    meta["t"] = _floats(m.group(2))[0]
                    continue
                vals = _floats(ln)
                if len(vals) >= 2 and _is_data_row(ln):
                    fit_rows.append(vals)
            flush()
        elif btype == 6:
            deg, b, coef = 5, None, {}
            for ln in lines:
                m = re.search(r"Degree of polynomial fit\s*=\s*(\d+)", ln)
                if m:
                    deg = int(m.group(1))
                m = re.search(r"Reference temperature\s*=\s*(\S+)", ln)
                if m:
                    t_ref_planck = _floats(m.group(1))[0]
                m = re.search(r"Band\s*=\s*(\d+)", ln)
                if m:
                    b = int(m.group(1)) - 1
                    coef[b] = []
                    continue
                if b is not None and ln.strip() and _is_data_row(ln):
                    coef[b].extend(_floats(ln))
            planck = np.zeros((nb, deg + 1))
            for b, c in coef.items():
                planck[b, :len(c)] = c[:deg + 1]
        elif btype == 9:
            b, ctype = None, 1
            for ln in lines:
                m = re.search(r"Band\s*=\s*(\d+)\s*.*type\s*=\s*(\d+)", ln,
                              re.IGNORECASE)
                if m:
                    b, ctype = int(m.group(1)) - 1, int(m.group(2))
                    continue
                vals = _floats(ln)
                if b is not None and len(vals) >= 5:
                    continuum.setdefault(b, []).append(Continuum(
                        k=vals[0], self_broadened=(ctype == 1),
                        p_ref_c=vals[1], t_ref_c=vals[2],
                        alpha=vals[3], beta=vals[4]))
                    b = None
        elif btype in (10, 12):
            coeffs, b = np.zeros((nb, 6)), None
            for ln in lines:
                m = re.search(r"Band\s*=\s*(\d+)", ln)
                if m:
                    b = int(m.group(1)) - 1
                    continue
                vals = _floats(ln)
                if b is not None and len(vals) >= 2:
                    coeffs[b, :len(vals[:6])] = vals[:6]
                    b = None
            if btype == 10:
                drop = coeffs
            else:
                ice = coeffs

    if not band_gases:
        band_gases = [[g for g in absorbers if (b, g) in esft]
                      for b in range(nb)]
    return SpectrumData(
        name=name or str(path), is_sw=solar is not None,
        wl_short=wl_short, wl_long=wl_long, absorbers=absorbers,
        band_gases=band_gases, esft=esft, solar_frac=solar,
        rayleigh=rayleigh, planck=planck, t_ref_planck=t_ref_planck,
        continuum=continuum, drop_coeffs=drop, ice_coeffs=ice)


# ---------------------------------------------------------------------------
# Synthetic spectra (ga7-like band structure, plausible magnitudes)
# ---------------------------------------------------------------------------

def _esft_terms(k_lo, k_hi, n, heavy_tail=0.45):
    """Log-spaced k ladder with geometrically decaying weights — the shape
    real ESFT fits take (most of the band is weak, a small weight is very
    strong)."""
    k = np.logspace(np.log10(k_lo), np.log10(k_hi), n)
    w = heavy_tail ** np.arange(n, dtype=np.float64)
    w /= w.sum()
    return k, w


def synthetic_sw_spectrum() -> SpectrumData:
    """6-band SW spectrum (0.2-10 um, HadGEM/ga7-like splits)."""
    edges = np.array([0.20, 0.32, 0.505, 0.69, 1.19, 2.38, 10.0]) * 1e-6
    wl_s, wl_l = edges[:-1], edges[1:]
    nb = 6
    # solar fractions: 5772 K Planck
    sf = np.array([band_planck_flux(wl_s[b], wl_l[b], 5772.0)
                   for b in range(nb)])
    sf /= sf.sum()
    # Rayleigh ~ lambda^-4 about 9.4e-6 m2/kg at 550 nm
    lam_eff = np.sqrt(wl_s * wl_l)
    rayleigh = 9.4e-6 * (0.55e-6 / lam_eff) ** 4

    esft, band_gases = {}, [[] for _ in range(nb)]

    def add(b, gas, k_lo, k_hi, n, scale=(0.8, 0.3)):
        k, w = _esft_terms(k_lo, k_hi, n)
        esft[(b, gas)] = GasFit(gas=gas, k=k, w=w, scale=scale)
        band_gases[b].append(gas)

    add(0, IP_O3, 5.0e1, 3.0e4, 5, scale=(0.0, 0.0))   # Hartley/Huggins
    add(1, IP_O3, 1.0e-1, 3.0e0, 3, scale=(0.0, 0.0))  # Huggins tail
    add(2, IP_O3, 1.0e0, 8.0e0, 3, scale=(0.0, 0.0))   # Chappuis
    add(3, IP_H2O, 1.0e-4, 5.0e-1, 5)                  # weak near-IR
    add(3, IP_O2, 5.0e-5, 5.0e-4, 2, scale=(1.0, 0.0))
    add(4, IP_H2O, 1.0e-3, 2.0e1, 6)                   # 1.4/1.9 um bands
    add(4, IP_CO2, 5.0e-4, 2.0e-2, 3)
    add(5, IP_H2O, 1.0e-2, 3.0e2, 6)                   # 2.7/6.3 um
    add(5, IP_CO2, 1.0e-3, 3.0e0, 4)

    # Slingo droplets: tau = cwp (a + b/re); 1-ssa = c + d re; g = e + f re
    drop = np.zeros((nb, 6))
    omc = np.array([1e-7, 1e-7, 1e-6, 1.5e-4, 1.5e-3, 1.0e-2])
    dre = np.array([1e-9, 1e-9, 1e-8, 5.0e-5, 5.5e-4, 2.5e-3])
    for b in range(nb):
        drop[b] = (2.0e-2, 1.3, omc[b], dre[b], 0.85, 9.0e-4)
    ice = np.zeros((nb, 6))
    for b in range(nb):
        ice[b] = (3.5e-3, 1.3, 2.0 * omc[b], 2.0 * dre[b], 0.80, 1.5e-3)

    return SpectrumData(
        name="synthetic_sw_6band", is_sw=True, wl_short=wl_s, wl_long=wl_l,
        absorbers=[IP_H2O, IP_CO2, IP_O3, IP_O2],
        band_gases=band_gases, esft=esft, solar_frac=sf, rayleigh=rayleigh,
        drop_coeffs=drop, ice_coeffs=ice)


def synthetic_lw_spectrum() -> SpectrumData:
    """9-band LW spectrum (3-1000 um; HadGEM-like wavenumber splits)."""
    # band edges in wavenumber [cm-1], low to high
    wn = np.array([10.0, 400.0, 550.0, 800.0, 990.0, 1120.0, 1330.0,
                   1500.0, 1850.0, 3500.0])
    wl_long = 1e-2 / wn[:-1]       # low wavenumber = long wavelength
    wl_short = 1e-2 / wn[1:]
    nb = 9

    esft, band_gases = {}, [[] for _ in range(nb)]

    def add(b, gas, k_lo, k_hi, n, scale=(0.7, 0.5)):
        k, w = _esft_terms(k_lo, k_hi, n)
        esft[(b, gas)] = GasFit(gas=gas, k=k, w=w, scale=scale)
        band_gases[b].append(gas)

    add(0, IP_H2O, 1.0e0, 1.0e3, 6)            # rotation band: opaque
    add(1, IP_H2O, 1.0e-1, 1.0e2, 6)
    add(2, IP_CO2, 1.0e-1, 3.0e3, 7)           # 15 um CO2
    add(2, IP_H2O, 1.0e-3, 1.0e0, 4)
    add(3, IP_H2O, 1.0e-4, 1.0e-1, 4)          # window
    add(4, IP_O3, 1.0e0, 3.0e2, 5)             # 9.6 um O3
    add(4, IP_H2O, 1.0e-4, 1.0e-1, 3)
    add(5, IP_H2O, 1.0e-3, 1.0e0, 4)           # window edge
    add(5, IP_CH4, 1.0e-1, 1.0e1, 3)
    add(5, IP_N2O, 1.0e-1, 1.0e1, 3)
    add(6, IP_H2O, 1.0e-2, 1.0e1, 4)
    add(6, IP_CH4, 1.0e-1, 3.0e1, 3)
    add(7, IP_H2O, 1.0e-1, 1.0e2, 5)           # 6.3 um vibration-rotation
    add(8, IP_H2O, 1.0e-1, 3.0e2, 5)

    continuum = {
        3: [Continuum(k=8.0e-3), Continuum(k=3.0e-4, self_broadened=False,
                                           p_ref_c=1.0e5, beta=1.0)],
        4: [Continuum(k=5.0e-3)],
        5: [Continuum(k=2.0e-3)],
    }

    planck = fit_planck_polynomial(wl_short, wl_long)

    drop = np.zeros((nb, 6))
    drop[:, 0], drop[:, 1] = 0.065, 0.4       # LW absorption a + b/re [m2/g]
    ice = np.zeros((nb, 6))
    ice[:, 0], ice[:, 1] = 0.035, 0.6

    return SpectrumData(
        name="synthetic_lw_9band", is_sw=False,
        wl_short=wl_short, wl_long=wl_long,
        absorbers=[IP_H2O, IP_CO2, IP_O3, IP_N2O, IP_CH4],
        band_gases=band_gases, esft=esft, planck=planck,
        continuum=continuum, drop_coeffs=drop, ice_coeffs=ice)
