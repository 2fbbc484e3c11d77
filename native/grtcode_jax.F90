!> @brief Fortran bindings for the grtcode_jax framework.
!>
!> Equivalent of the reference's `module grtcode`
!> (fortran-bindings/grtcode_fortran.F90:20-116): the same public constants
!> (HITRAN molecule ids H2O=1..CS2=53, CFC ids CFC11=0..SF6=20, CIA ids) and
!> the same f_* wrapper surface (device / spectral grid / optics / solar flux
!> / gas optics / rayleigh, grtcode_fortran.F90:585-893), bound over the C ABI
!> in native/grtcode_jax_c.h instead of opaque malloc'd structs
!> (malloc_structs.c:40-67).  Handles are plain c_int64_t.  All arrays are
!> double precision regardless of the device compute dtype (the JAX pipeline
!> runs f32 with f64-sensitive accumulations; see SURVEY.md §7).
module grtcode_jax
use, intrinsic :: iso_c_binding, only: c_char, c_double, c_int, c_int64_t, &
                                       c_null_char
implicit none
private

integer, parameter, public :: grt_handle_kind = c_int64_t
integer(kind=c_int), parameter, public :: grtcode_success = 0

! HITRAN molecule ids (gas-optics/src/molecules.h:31-104).
integer(kind=c_int), parameter, public :: H2O = 1, CO2 = 2, O3 = 3, N2O = 4, &
    CO = 5, CH4 = 6, O2 = 7, NO = 8, SO2 = 9, NO2 = 10, NH3 = 11, HNO3 = 12, &
    OH = 13, HF = 14, HCl = 15, HBr = 16, HI = 17, ClO = 18, OCS = 19, &
    H2CO = 20, HOCl = 21, N2 = 22, HCN = 23, CH3Cl = 24, H2O2 = 25, &
    C2H2 = 26, C2H6 = 27, PH3 = 28, COF2 = 29, SF6_MOL = 30, H2S = 31, &
    HCOOH = 32, HO2 = 33, O = 34, ClONO2 = 35, NOp = 36, HOBr = 37, &
    C2H4 = 38, CH3OH = 39, CH3Br = 40, CH3CN = 41, CF4_MOL = 42, C4H2 = 43, &
    HC3N = 44, H2 = 45, CS = 46, SO3 = 47, C2N2 = 48, COCl2 = 49, SO = 50, &
    C3H4 = 51, CH3 = 52, CS2 = 53, MAX_NUM_MOLECULES = 53

! CFC/HFC cross-section ids (gas-optics/src/cfcs.h:32-67).
integer(kind=c_int), parameter, public :: CFC11 = 0, CFC12 = 1, CFC113 = 2, &
    CFC114 = 3, CFC115 = 4, HCFC22 = 5, HCFC141b = 6, HCFC142b = 7, &
    HFC23 = 8, HFC125 = 9, HFC134a = 10, HFC143a = 11, HFC152a = 12, &
    HFC227ea = 13, HFC245fa = 14, CCl4 = 15, C2F6 = 16, CF4 = 17, &
    CH2Cl2 = 18, NF3 = 19, SF6 = 20, MAX_NUM_CFCS = 21

! Collision-induced-absorption species ids
! (gas-optics/src/collision_induced_absorption.h:36-53).
integer(kind=c_int), parameter, public :: CIA_N2 = 0, CIA_O2 = 1, &
    MAX_NUM_CIAS = 2

public :: f_set_verbosity
public :: f_initialize, f_finalize, f_create_device, f_use_device, &
          f_num_devices, &
          f_create_spectral_grid, f_spectral_grid_properties, &
          f_create_optics, f_optics_properties, f_add_optics, &
          f_create_solar_flux, f_solar_flux_properties, &
          f_create_gas_optics, f_add_molecule, f_num_molecules, &
          f_set_molecule_ppmv, f_add_cfc, f_set_cfc_ppmv, f_add_cia, &
          f_set_cia_ppmv, f_calculate_optical_depth, &
          f_rayleigh_scattering, f_longwave_fluxes, f_shortwave_fluxes, &
          f_destroy

interface

function f_initialize() bind(c, name="grt_initialize") result(rc)
import c_int
integer(kind=c_int) :: rc
end function f_initialize

function f_finalize() bind(c, name="grt_finalize") result(rc)
import c_int
integer(kind=c_int) :: rc
end function f_finalize

  !> Verbosity: 0 = none, 1 = warnings, 2 = info (grtcode verbosity_).
  function f_set_verbosity(level) bind(c, name="grt_set_verbosity") &
      result(rc)
    import :: c_int
    integer(c_int), value, intent(in) :: level
    integer(c_int) :: rc
  end function f_set_verbosity

!> Mirrors f_create_device (grtcode_fortran.F90:585-591); id = -1 -> host.
function f_create_device(device_id, handle) &
    bind(c, name="grt_create_device") result(rc)
import c_int, c_int64_t
integer(kind=c_int), intent(in), value :: device_id
integer(kind=c_int64_t), intent(out) :: handle
integer(kind=c_int) :: rc
end function f_create_device

!> Makes the device the default placement for compute calls
!> (grt_use_device, native/grtcode_jax_c.h).
function f_use_device(device) bind(c, name="grt_use_device") result(rc)
import c_int, c_int64_t
integer(kind=c_int64_t), intent(in), value :: device
integer(kind=c_int) :: rc
end function f_use_device

function f_num_devices(n) bind(c, name="grt_num_devices") result(rc)
import c_int
integer(kind=c_int), intent(out) :: n
integer(kind=c_int) :: rc
end function f_num_devices

!> Mirrors f_create_spectral_grid (grtcode_fortran.F90:594-607).
function f_create_spectral_grid(w0, wn, dw, handle) &
    bind(c, name="grt_create_spectral_grid") result(rc)
import c_double, c_int, c_int64_t
real(kind=c_double), intent(in), value :: w0, wn, dw
integer(kind=c_int64_t), intent(out) :: handle
integer(kind=c_int) :: rc
end function f_create_spectral_grid

!> props = [w0, num_points, dw] (grtcode_fortran.F90:657-665).
function f_spectral_grid_properties(grid, props) &
    bind(c, name="grt_spectral_grid_properties") result(rc)
import c_double, c_int, c_int64_t
integer(kind=c_int64_t), intent(in), value :: grid
real(kind=c_double), dimension(3), intent(out) :: props
integer(kind=c_int) :: rc
end function f_spectral_grid_properties

!> Mirrors f_create_optics (grtcode_fortran.F90:618-631).
function f_create_optics(num_layers, grid, handle) &
    bind(c, name="grt_create_optics") result(rc)
import c_int, c_int64_t
integer(kind=c_int), intent(in), value :: num_layers
integer(kind=c_int64_t), intent(in), value :: grid
integer(kind=c_int64_t), intent(out) :: handle
integer(kind=c_int) :: rc
end function f_create_optics

!> Mirrors f_optical_properties (grtcode_fortran.F90:646-654); arrays are
!> (num_layers, num_wavenumbers) row-major from C (transpose in Fortran).
function f_optics_properties(optics, tau, omega, g) &
    bind(c, name="grt_optics_properties") result(rc)
import c_double, c_int, c_int64_t
integer(kind=c_int64_t), intent(in), value :: optics
real(kind=c_double), dimension(*), intent(out) :: tau, omega, g
integer(kind=c_int) :: rc
end function f_optics_properties

!> Mirrors f_add_optics (grtcode_fortran.F90:668-683).
function f_add_optics(result_optics, parts, n) &
    bind(c, name="grt_add_optics") result(rc)
import c_int, c_int64_t
integer(kind=c_int64_t), intent(in), value :: result_optics
integer(kind=c_int64_t), dimension(*), intent(in) :: parts
integer(kind=c_int), intent(in), value :: n
integer(kind=c_int) :: rc
end function f_add_optics

!> Raw C interface; use the f_create_solar_flux wrapper, which
!> null-terminates the path (mirrors append_null_char,
!> fortran-bindings/grtcode_fortran.F90:123-133).
function c_create_solar_flux(grid, csv_path, handle) &
    bind(c, name="grt_create_solar_flux") result(rc)
import c_char, c_int, c_int64_t
integer(kind=c_int64_t), intent(in), value :: grid
character(kind=c_char), dimension(*), intent(in) :: csv_path
integer(kind=c_int64_t), intent(out) :: handle
integer(kind=c_int) :: rc
end function c_create_solar_flux

!> Mirrors f_solar_flux_properties (grtcode_fortran.F90:716-722).
function f_solar_flux_properties(solar, incident_flux) &
    bind(c, name="grt_solar_flux_properties") result(rc)
import c_double, c_int, c_int64_t
integer(kind=c_int64_t), intent(in), value :: solar
real(kind=c_double), dimension(*), intent(out) :: incident_flux
integer(kind=c_int) :: rc
end function f_solar_flux_properties

!> Raw C interface; use the f_create_gas_optics wrapper.
function c_create_gas_optics(grid, num_levels, hitran_path, h2o_ctm_dir, &
                             o3_ctm_file, handle) &
    bind(c, name="grt_create_gas_optics") result(rc)
import c_char, c_int, c_int64_t
integer(kind=c_int64_t), intent(in), value :: grid
integer(kind=c_int), intent(in), value :: num_levels
character(kind=c_char), dimension(*), intent(in) :: hitran_path
character(kind=c_char), dimension(*), intent(in) :: h2o_ctm_dir
character(kind=c_char), dimension(*), intent(in) :: o3_ctm_file
integer(kind=c_int64_t), intent(out) :: handle
integer(kind=c_int) :: rc
end function c_create_gas_optics

!> Mirrors f_add_molecule (grtcode_fortran.F90:777-785); pass <= 0 bounds
!> for "use grid bounds".
function f_add_molecule(gas, molecule_id, min_line_center, max_line_center) &
    bind(c, name="grt_add_molecule") result(rc)
import c_double, c_int, c_int64_t
integer(kind=c_int64_t), intent(in), value :: gas
integer(kind=c_int), intent(in), value :: molecule_id
real(kind=c_double), intent(in), value :: min_line_center, max_line_center
integer(kind=c_int) :: rc
end function f_add_molecule

!> Mirrors f_num_molecules (grtcode_fortran.F90:856-862).
function f_num_molecules(gas, n) bind(c, name="grt_num_molecules") result(rc)
import c_int, c_int64_t
integer(kind=c_int64_t), intent(in), value :: gas
integer(kind=c_int), intent(out) :: n
integer(kind=c_int) :: rc
end function f_num_molecules

!> Mirrors f_set_molecule_ppmv (grtcode_fortran.F90:788-795).
function f_set_molecule_ppmv(gas, molecule_id, ppmv) &
    bind(c, name="grt_set_molecule_ppmv") result(rc)
import c_double, c_int, c_int64_t
integer(kind=c_int64_t), intent(in), value :: gas
integer(kind=c_int), intent(in), value :: molecule_id
real(kind=c_double), dimension(*), intent(in) :: ppmv
integer(kind=c_int) :: rc
end function f_set_molecule_ppmv

!> Raw C interface; use the f_add_cfc wrapper.
function c_add_cfc(gas, cfc_id, csv_path) &
    bind(c, name="grt_add_cfc") result(rc)
import c_char, c_int, c_int64_t
integer(kind=c_int64_t), intent(in), value :: gas
integer(kind=c_int), intent(in), value :: cfc_id
character(kind=c_char), dimension(*), intent(in) :: csv_path
integer(kind=c_int) :: rc
end function c_add_cfc

!> Mirrors f_set_cfc_ppmv (grtcode_fortran.F90:811-818).
function f_set_cfc_ppmv(gas, cfc_id, ppmv) &
    bind(c, name="grt_set_cfc_ppmv") result(rc)
import c_double, c_int, c_int64_t
integer(kind=c_int64_t), intent(in), value :: gas
integer(kind=c_int), intent(in), value :: cfc_id
real(kind=c_double), dimension(*), intent(in) :: ppmv
integer(kind=c_int) :: rc
end function f_set_cfc_ppmv

!> Raw C interface; use the f_add_cia wrapper.
function c_add_cia(gas, species1, species2, csv_path) &
    bind(c, name="grt_add_cia") result(rc)
import c_char, c_int, c_int64_t
integer(kind=c_int64_t), intent(in), value :: gas
integer(kind=c_int), intent(in), value :: species1, species2
character(kind=c_char), dimension(*), intent(in) :: csv_path
integer(kind=c_int) :: rc
end function c_add_cia

!> Mirrors f_set_cia_ppmv (grtcode_fortran.F90:835-842).
function f_set_cia_ppmv(gas, species_id, ppmv) &
    bind(c, name="grt_set_cia_ppmv") result(rc)
import c_double, c_int, c_int64_t
integer(kind=c_int64_t), intent(in), value :: gas
integer(kind=c_int), intent(in), value :: species_id
real(kind=c_double), dimension(*), intent(in) :: ppmv
integer(kind=c_int) :: rc
end function f_set_cia_ppmv

!> Mirrors f_calculate_optics (grtcode_fortran.F90:845-853).
function f_calculate_optical_depth(gas, pressure_mb, temperature, optics) &
    bind(c, name="grt_calculate_optical_depth") result(rc)
import c_double, c_int, c_int64_t
integer(kind=c_int64_t), intent(in), value :: gas
real(kind=c_double), dimension(*), intent(in) :: pressure_mb, temperature
integer(kind=c_int64_t), intent(in), value :: optics
integer(kind=c_int) :: rc
end function f_calculate_optical_depth

!> Mirrors f_rayleigh_scattering (grtcode_fortran.F90:883-889).
function f_rayleigh_scattering(optics, pressure_mb) &
    bind(c, name="grt_rayleigh_scattering") result(rc)
import c_double, c_int, c_int64_t
integer(kind=c_int64_t), intent(in), value :: optics
real(kind=c_double), dimension(*), intent(in) :: pressure_mb
integer(kind=c_int) :: rc
end function f_rayleigh_scattering

!> LW solver (C-only in the reference, longwave/src/longwave.c:312-353).
!> t_layers is the explicit num_layers layer-temperature array, matching
!> calculate_lw_fluxes' T_layers argument.
function f_longwave_fluxes(optics, t_surf, t_levels, t_layers, emissivity, &
                           flux_up, flux_down) &
    bind(c, name="grt_longwave_fluxes") result(rc)
import c_double, c_int, c_int64_t
integer(kind=c_int64_t), intent(in), value :: optics
real(kind=c_double), intent(in), value :: t_surf
real(kind=c_double), dimension(*), intent(in) :: t_levels, t_layers, &
                                                 emissivity
real(kind=c_double), dimension(*), intent(out) :: flux_up, flux_down
integer(kind=c_int) :: rc
end function f_longwave_fluxes

!> SW solver (C-only in the reference, shortwave/src/shortwave.c:506-547).
function f_shortwave_fluxes(optics, mu_dir, mu_dif, albedo_dir, albedo_dif, &
                            total_solar_irradiance, solar, flux_up, &
                            flux_down) &
    bind(c, name="grt_shortwave_fluxes") result(rc)
import c_double, c_int, c_int64_t
integer(kind=c_int64_t), intent(in), value :: optics
real(kind=c_double), intent(in), value :: mu_dir, mu_dif
real(kind=c_double), dimension(*), intent(in) :: albedo_dir, albedo_dif
real(kind=c_double), intent(in), value :: total_solar_irradiance
integer(kind=c_int64_t), intent(in), value :: solar
real(kind=c_double), dimension(*), intent(out) :: flux_up, flux_down
integer(kind=c_int) :: rc
end function f_shortwave_fluxes

!> Generic destroy_* (grtcode_fortran.F90:634-643, 704-713, 765-774).
function f_destroy(handle) bind(c, name="grt_destroy") result(rc)
import c_int, c_int64_t
integer(kind=c_int64_t), intent(in), value :: handle
integer(kind=c_int) :: rc
end function f_destroy

end interface

contains

!> Null-terminated copy of a Fortran string for the C ABI (equivalent of
!> the reference's append_null_char, fortran-bindings/grtcode_fortran.F90).
pure function null_terminate(s) result(c)
character(len=*), intent(in) :: s
character(kind=c_char, len=len_trim(s)+1) :: c
c = trim(s)//c_null_char
end function null_terminate

!> Mirrors f_create_solar_flux (grtcode_fortran.F90:686-701); accepts a
!> plain Fortran string and null-terminates it.
function f_create_solar_flux(grid, csv_path, handle) result(rc)
integer(kind=c_int64_t), intent(in) :: grid
character(len=*), intent(in) :: csv_path
integer(kind=c_int64_t), intent(out) :: handle
integer(kind=c_int) :: rc
rc = c_create_solar_flux(grid, null_terminate(csv_path), handle)
end function f_create_solar_flux

!> Mirrors f_create_gas_optics (grtcode_fortran.F90:725-762).  Pass empty
!> strings to skip the HITRAN database or either continuum.
function f_create_gas_optics(grid, num_levels, hitran_path, h2o_ctm_dir, &
                             o3_ctm_file, handle) result(rc)
integer(kind=c_int64_t), intent(in) :: grid
integer(kind=c_int), intent(in) :: num_levels
character(len=*), intent(in) :: hitran_path, h2o_ctm_dir, o3_ctm_file
integer(kind=c_int64_t), intent(out) :: handle
integer(kind=c_int) :: rc
rc = c_create_gas_optics(grid, num_levels, null_terminate(hitran_path), &
                         null_terminate(h2o_ctm_dir), &
                         null_terminate(o3_ctm_file), handle)
end function f_create_gas_optics

!> Mirrors f_add_cfc (grtcode_fortran.F90:798-808).
function f_add_cfc(gas, cfc_id, csv_path) result(rc)
integer(kind=c_int64_t), intent(in) :: gas
integer(kind=c_int), intent(in) :: cfc_id
character(len=*), intent(in) :: csv_path
integer(kind=c_int) :: rc
rc = c_add_cfc(gas, cfc_id, null_terminate(csv_path))
end function f_add_cfc

!> Mirrors f_add_cia (grtcode_fortran.F90:821-832).
function f_add_cia(gas, species1, species2, csv_path) result(rc)
integer(kind=c_int64_t), intent(in) :: gas
integer(kind=c_int), intent(in) :: species1, species2
character(len=*), intent(in) :: csv_path
integer(kind=c_int) :: rc
rc = c_add_cia(gas, species1, species2, null_terminate(csv_path))
end function f_add_cia

end module grtcode_jax
