"""Physical constants (the port's own copy of
geosradiation_gridcomp_tpu/constants.py, value for value).

Values match the reference's MAPL/RRTMG conventions so flux/heating-rate
comparisons are apples-to-apples (e.g. rrtmg_lw_init.F90:212-236 NIST-2002
constants; MAPL_Constants for g/cp used in heating-rate synthesis,
GEOS_RadiationGridComp.F90:798-819).
"""

GRAV = 9.80665          # m s-2 (MAPL_GRAV)
CP = 1004.16            # J kg-1 K-1 (MAPL_CP, dry air)
RGAS = 8.31446          # J mol-1 K-1
AVOGAD = 6.02214199e23  # mol-1 (rrtmg_lw_init.F90:225)
AMD = 28.9660           # g/mol dry air  (rrtmg_sw_rad.F90 amd)
AMW = 18.0160           # g/mol water    (rrtmg amw)
AMO3 = 47.9982          # g/mol ozone
AMCO2 = 44.0098
AMCH4 = 16.0430
AMN2O = 44.0128
AMO2 = 31.9988
AMCFC11 = 137.3684
AMCFC12 = 120.9138
AMHCFC22 = 86.4690
AMCCL4 = 153.8230

STEFAN_BOLTZMANN = 5.670400e-8  # W m-2 K-4 (rrtmg sbcnst in cgs: 5.6704e-4)

# Diffusivity factor used by the Chou LW scheme and getirtau (1/cos(53deg))
DIFFUSIVITY = 1.66

SECONDS_PER_DAY = 86400.0
