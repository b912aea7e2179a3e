!> Fortran iso_c_binding module for libchase_tpu — the reference's
!> interface/chase_fortran_interface.f90 analogue, covering the FULL C ABI
!> export surface ({s,d,c,z}chase_* serial, p*chase_* distributed, the
!> *_pseudo BSE variants, Hamiltonian IO, and the unified config setters).
!> Consistency with libchase_tpu.so is enforced by tests/test_fortran_abi.py
!> (every bind(c) name must resolve against the export table and vice
!> versa); the module also compiles + links a demo when a Fortran compiler
!> is present.  Build the library with:
!>   python -c "from chase_tpu._native import build_capi; build_capi()"
module chase_tpu_interface
    use iso_c_binding
    implicit none

    interface
        subroutine schase_init(n, nev, nex, h, ldh, v, ritzv, init) &
            bind(c, name='schase_init_')
            use iso_c_binding
            integer(c_int) :: n, nev, nex, ldh, init
            real(c_float) :: h(ldh, *), v(n, *)
            real(c_float) :: ritzv(*)
        end subroutine schase_init

        subroutine pschase_init(n, nev, nex, m, mloc, h, ldh, v, ritzv, &
                dim0, dim1, grid_major, comm, init) &
            bind(c, name='pschase_init_')
            use iso_c_binding
            integer(c_int) :: n, nev, nex, m, mloc, ldh, dim0, dim1
            integer(c_int) :: comm, init
            character(len=1, kind=c_char) :: grid_major
            real(c_float) :: h(ldh, *), v(n, *)
            real(c_float) :: ritzv(*)
        end subroutine pschase_init

        subroutine dchase_init(n, nev, nex, h, ldh, v, ritzv, init) &
            bind(c, name='dchase_init_')
            use iso_c_binding
            integer(c_int) :: n, nev, nex, ldh, init
            real(c_double) :: h(ldh, *), v(n, *)
            real(c_double) :: ritzv(*)
        end subroutine dchase_init

        subroutine pdchase_init(n, nev, nex, m, mloc, h, ldh, v, ritzv, &
                dim0, dim1, grid_major, comm, init) &
            bind(c, name='pdchase_init_')
            use iso_c_binding
            integer(c_int) :: n, nev, nex, m, mloc, ldh, dim0, dim1
            integer(c_int) :: comm, init
            character(len=1, kind=c_char) :: grid_major
            real(c_double) :: h(ldh, *), v(n, *)
            real(c_double) :: ritzv(*)
        end subroutine pdchase_init

        subroutine cchase_init(n, nev, nex, h, ldh, v, ritzv, init) &
            bind(c, name='cchase_init_')
            use iso_c_binding
            integer(c_int) :: n, nev, nex, ldh, init
            complex(c_float_complex) :: h(ldh, *), v(n, *)
            real(c_float) :: ritzv(*)
        end subroutine cchase_init

        subroutine pcchase_init(n, nev, nex, m, mloc, h, ldh, v, ritzv, &
                dim0, dim1, grid_major, comm, init) &
            bind(c, name='pcchase_init_')
            use iso_c_binding
            integer(c_int) :: n, nev, nex, m, mloc, ldh, dim0, dim1
            integer(c_int) :: comm, init
            character(len=1, kind=c_char) :: grid_major
            complex(c_float_complex) :: h(ldh, *), v(n, *)
            real(c_float) :: ritzv(*)
        end subroutine pcchase_init

        subroutine zchase_init(n, nev, nex, h, ldh, v, ritzv, init) &
            bind(c, name='zchase_init_')
            use iso_c_binding
            integer(c_int) :: n, nev, nex, ldh, init
            complex(c_double_complex) :: h(ldh, *), v(n, *)
            real(c_double) :: ritzv(*)
        end subroutine zchase_init

        subroutine pzchase_init(n, nev, nex, m, mloc, h, ldh, v, ritzv, &
                dim0, dim1, grid_major, comm, init) &
            bind(c, name='pzchase_init_')
            use iso_c_binding
            integer(c_int) :: n, nev, nex, m, mloc, ldh, dim0, dim1
            integer(c_int) :: comm, init
            character(len=1, kind=c_char) :: grid_major
            complex(c_double_complex) :: h(ldh, *), v(n, *)
            real(c_double) :: ritzv(*)
        end subroutine pzchase_init

        subroutine cchase_init_pseudo(n, nev, nex, h, ldh, v, ritzv, init) &
            bind(c, name='cchase_init_pseudo_')
            use iso_c_binding
            integer(c_int) :: n, nev, nex, ldh, init
            complex(c_float_complex) :: h(ldh, *), v(n, *)
            real(c_float) :: ritzv(*)
        end subroutine cchase_init_pseudo

        subroutine zchase_init_pseudo(n, nev, nex, h, ldh, v, ritzv, init) &
            bind(c, name='zchase_init_pseudo_')
            use iso_c_binding
            integer(c_int) :: n, nev, nex, ldh, init
            complex(c_double_complex) :: h(ldh, *), v(n, *)
            real(c_double) :: ritzv(*)
        end subroutine zchase_init_pseudo

        ! -- serial init without user V/ritzv: the library allocates the
        !    search space internally (chase_c_interface.h:25-32, 49-55) --

        subroutine schase_init_internal(n, nev, nex, h, ldh, init) &
            bind(c, name='schase_init_internal_')
            use iso_c_binding
            integer(c_int) :: n, nev, nex, ldh, init
            real(c_float) :: h(ldh, *)
        end subroutine schase_init_internal

        subroutine dchase_init_internal(n, nev, nex, h, ldh, init) &
            bind(c, name='dchase_init_internal_')
            use iso_c_binding
            integer(c_int) :: n, nev, nex, ldh, init
            real(c_double) :: h(ldh, *)
        end subroutine dchase_init_internal

        subroutine cchase_init_internal(n, nev, nex, h, ldh, init) &
            bind(c, name='cchase_init_internal_')
            use iso_c_binding
            integer(c_int) :: n, nev, nex, ldh, init
            complex(c_float_complex) :: h(ldh, *)
        end subroutine cchase_init_internal

        subroutine zchase_init_internal(n, nev, nex, h, ldh, init) &
            bind(c, name='zchase_init_internal_')
            use iso_c_binding
            integer(c_int) :: n, nev, nex, ldh, init
            complex(c_double_complex) :: h(ldh, *)
        end subroutine zchase_init_internal

        subroutine cchase_init_pseudo_internal(n, nev, nex, h, ldh, init) &
            bind(c, name='cchase_init_pseudo_internal_')
            use iso_c_binding
            integer(c_int) :: n, nev, nex, ldh, init
            complex(c_float_complex) :: h(ldh, *)
        end subroutine cchase_init_pseudo_internal

        subroutine zchase_init_pseudo_internal(n, nev, nex, h, ldh, init) &
            bind(c, name='zchase_init_pseudo_internal_')
            use iso_c_binding
            integer(c_int) :: n, nev, nex, ldh, init
            complex(c_double_complex) :: h(ldh, *)
        end subroutine zchase_init_pseudo_internal


        ! -- distributed init variants (chase_c_interface.h:61-175) --

        subroutine pschase_init_internal(n, nev, nex, m, mloc, h, ldh, &
                dim0, dim1, grid_major, comm, init) &
            bind(c, name='pschase_init_internal_')
            use iso_c_binding
            integer(c_int) :: n, nev, nex, m, mloc, ldh, dim0, dim1
            integer(c_int) :: comm, init
            character(len=1, kind=c_char) :: grid_major
            real(c_float) :: h(ldh, *)
        end subroutine pschase_init_internal

        subroutine pschase_init_blockcyclic(n, nev, nex, mbsize, nbsize, h, ldh, &
                v, ritzv, dim0, dim1, grid_major, irsrc, icsrc, comm, init) &
            bind(c, name='pschase_init_blockcyclic_')
            use iso_c_binding
            integer(c_int) :: n, nev, nex, mbsize, nbsize, ldh, dim0, dim1
            integer(c_int) :: irsrc, icsrc, comm, init
            character(len=1, kind=c_char) :: grid_major
            real(c_float) :: h(ldh, *), v(n, *)
            real(c_float) :: ritzv(*)
        end subroutine pschase_init_blockcyclic

        subroutine pschase_init_blockcyclic_internal(n, nev, nex, mbsize, nbsize, h, ldh, &
                dim0, dim1, grid_major, irsrc, icsrc, comm, init) &
            bind(c, name='pschase_init_blockcyclic_internal_')
            use iso_c_binding
            integer(c_int) :: n, nev, nex, mbsize, nbsize, ldh, dim0, dim1
            integer(c_int) :: irsrc, icsrc, comm, init
            character(len=1, kind=c_char) :: grid_major
            real(c_float) :: h(ldh, *)
        end subroutine pschase_init_blockcyclic_internal

        subroutine pdchase_init_internal(n, nev, nex, m, mloc, h, ldh, &
                dim0, dim1, grid_major, comm, init) &
            bind(c, name='pdchase_init_internal_')
            use iso_c_binding
            integer(c_int) :: n, nev, nex, m, mloc, ldh, dim0, dim1
            integer(c_int) :: comm, init
            character(len=1, kind=c_char) :: grid_major
            real(c_double) :: h(ldh, *)
        end subroutine pdchase_init_internal

        subroutine pdchase_init_blockcyclic(n, nev, nex, mbsize, nbsize, h, ldh, &
                v, ritzv, dim0, dim1, grid_major, irsrc, icsrc, comm, init) &
            bind(c, name='pdchase_init_blockcyclic_')
            use iso_c_binding
            integer(c_int) :: n, nev, nex, mbsize, nbsize, ldh, dim0, dim1
            integer(c_int) :: irsrc, icsrc, comm, init
            character(len=1, kind=c_char) :: grid_major
            real(c_double) :: h(ldh, *), v(n, *)
            real(c_double) :: ritzv(*)
        end subroutine pdchase_init_blockcyclic

        subroutine pdchase_init_blockcyclic_internal(n, nev, nex, mbsize, nbsize, h, ldh, &
                dim0, dim1, grid_major, irsrc, icsrc, comm, init) &
            bind(c, name='pdchase_init_blockcyclic_internal_')
            use iso_c_binding
            integer(c_int) :: n, nev, nex, mbsize, nbsize, ldh, dim0, dim1
            integer(c_int) :: irsrc, icsrc, comm, init
            character(len=1, kind=c_char) :: grid_major
            real(c_double) :: h(ldh, *)
        end subroutine pdchase_init_blockcyclic_internal

        subroutine pcchase_init_internal(n, nev, nex, m, mloc, h, ldh, &
                dim0, dim1, grid_major, comm, init) &
            bind(c, name='pcchase_init_internal_')
            use iso_c_binding
            integer(c_int) :: n, nev, nex, m, mloc, ldh, dim0, dim1
            integer(c_int) :: comm, init
            character(len=1, kind=c_char) :: grid_major
            complex(c_float_complex) :: h(ldh, *)
        end subroutine pcchase_init_internal

        subroutine pcchase_init_blockcyclic(n, nev, nex, mbsize, nbsize, h, ldh, &
                v, ritzv, dim0, dim1, grid_major, irsrc, icsrc, comm, init) &
            bind(c, name='pcchase_init_blockcyclic_')
            use iso_c_binding
            integer(c_int) :: n, nev, nex, mbsize, nbsize, ldh, dim0, dim1
            integer(c_int) :: irsrc, icsrc, comm, init
            character(len=1, kind=c_char) :: grid_major
            complex(c_float_complex) :: h(ldh, *), v(n, *)
            real(c_float) :: ritzv(*)
        end subroutine pcchase_init_blockcyclic

        subroutine pcchase_init_blockcyclic_internal(n, nev, nex, mbsize, nbsize, h, ldh, &
                dim0, dim1, grid_major, irsrc, icsrc, comm, init) &
            bind(c, name='pcchase_init_blockcyclic_internal_')
            use iso_c_binding
            integer(c_int) :: n, nev, nex, mbsize, nbsize, ldh, dim0, dim1
            integer(c_int) :: irsrc, icsrc, comm, init
            character(len=1, kind=c_char) :: grid_major
            complex(c_float_complex) :: h(ldh, *)
        end subroutine pcchase_init_blockcyclic_internal

        subroutine pzchase_init_internal(n, nev, nex, m, mloc, h, ldh, &
                dim0, dim1, grid_major, comm, init) &
            bind(c, name='pzchase_init_internal_')
            use iso_c_binding
            integer(c_int) :: n, nev, nex, m, mloc, ldh, dim0, dim1
            integer(c_int) :: comm, init
            character(len=1, kind=c_char) :: grid_major
            complex(c_double_complex) :: h(ldh, *)
        end subroutine pzchase_init_internal

        subroutine pzchase_init_blockcyclic(n, nev, nex, mbsize, nbsize, h, ldh, &
                v, ritzv, dim0, dim1, grid_major, irsrc, icsrc, comm, init) &
            bind(c, name='pzchase_init_blockcyclic_')
            use iso_c_binding
            integer(c_int) :: n, nev, nex, mbsize, nbsize, ldh, dim0, dim1
            integer(c_int) :: irsrc, icsrc, comm, init
            character(len=1, kind=c_char) :: grid_major
            complex(c_double_complex) :: h(ldh, *), v(n, *)
            real(c_double) :: ritzv(*)
        end subroutine pzchase_init_blockcyclic

        subroutine pzchase_init_blockcyclic_internal(n, nev, nex, mbsize, nbsize, h, ldh, &
                dim0, dim1, grid_major, irsrc, icsrc, comm, init) &
            bind(c, name='pzchase_init_blockcyclic_internal_')
            use iso_c_binding
            integer(c_int) :: n, nev, nex, mbsize, nbsize, ldh, dim0, dim1
            integer(c_int) :: irsrc, icsrc, comm, init
            character(len=1, kind=c_char) :: grid_major
            complex(c_double_complex) :: h(ldh, *)
        end subroutine pzchase_init_blockcyclic_internal

        subroutine pcchase_init_pseudo(n, nev, nex, m, mloc, h, ldh, v, ritzv, &
                dim0, dim1, grid_major, comm, init) &
            bind(c, name='pcchase_init_pseudo_')
            use iso_c_binding
            integer(c_int) :: n, nev, nex, m, mloc, ldh, dim0, dim1
            integer(c_int) :: comm, init
            character(len=1, kind=c_char) :: grid_major
            complex(c_float_complex) :: h(ldh, *), v(n, *)
            real(c_float) :: ritzv(*)
        end subroutine pcchase_init_pseudo

        subroutine pcchase_init_pseudo_internal(n, nev, nex, m, mloc, h, ldh, &
                dim0, dim1, grid_major, comm, init) &
            bind(c, name='pcchase_init_pseudo_internal_')
            use iso_c_binding
            integer(c_int) :: n, nev, nex, m, mloc, ldh, dim0, dim1
            integer(c_int) :: comm, init
            character(len=1, kind=c_char) :: grid_major
            complex(c_float_complex) :: h(ldh, *)
        end subroutine pcchase_init_pseudo_internal

        subroutine pcchase_init_pseudo_blockcyclic(n, nev, nex, mbsize, nbsize, h, ldh, &
                v, ritzv, dim0, dim1, grid_major, irsrc, icsrc, comm, init) &
            bind(c, name='pcchase_init_pseudo_blockcyclic_')
            use iso_c_binding
            integer(c_int) :: n, nev, nex, mbsize, nbsize, ldh, dim0, dim1
            integer(c_int) :: irsrc, icsrc, comm, init
            character(len=1, kind=c_char) :: grid_major
            complex(c_float_complex) :: h(ldh, *), v(n, *)
            real(c_float) :: ritzv(*)
        end subroutine pcchase_init_pseudo_blockcyclic

        subroutine pcchase_init_pseudo_blockcyclic_internal(n, nev, nex, mbsize, nbsize, h, ldh, &
                dim0, dim1, grid_major, irsrc, icsrc, comm, init) &
            bind(c, name='pcchase_init_pseudo_blockcyclic_internal_')
            use iso_c_binding
            integer(c_int) :: n, nev, nex, mbsize, nbsize, ldh, dim0, dim1
            integer(c_int) :: irsrc, icsrc, comm, init
            character(len=1, kind=c_char) :: grid_major
            complex(c_float_complex) :: h(ldh, *)
        end subroutine pcchase_init_pseudo_blockcyclic_internal

        subroutine pzchase_init_pseudo(n, nev, nex, m, mloc, h, ldh, v, ritzv, &
                dim0, dim1, grid_major, comm, init) &
            bind(c, name='pzchase_init_pseudo_')
            use iso_c_binding
            integer(c_int) :: n, nev, nex, m, mloc, ldh, dim0, dim1
            integer(c_int) :: comm, init
            character(len=1, kind=c_char) :: grid_major
            complex(c_double_complex) :: h(ldh, *), v(n, *)
            real(c_double) :: ritzv(*)
        end subroutine pzchase_init_pseudo

        subroutine pzchase_init_pseudo_internal(n, nev, nex, m, mloc, h, ldh, &
                dim0, dim1, grid_major, comm, init) &
            bind(c, name='pzchase_init_pseudo_internal_')
            use iso_c_binding
            integer(c_int) :: n, nev, nex, m, mloc, ldh, dim0, dim1
            integer(c_int) :: comm, init
            character(len=1, kind=c_char) :: grid_major
            complex(c_double_complex) :: h(ldh, *)
        end subroutine pzchase_init_pseudo_internal

        subroutine pzchase_init_pseudo_blockcyclic(n, nev, nex, mbsize, nbsize, h, ldh, &
                v, ritzv, dim0, dim1, grid_major, irsrc, icsrc, comm, init) &
            bind(c, name='pzchase_init_pseudo_blockcyclic_')
            use iso_c_binding
            integer(c_int) :: n, nev, nex, mbsize, nbsize, ldh, dim0, dim1
            integer(c_int) :: irsrc, icsrc, comm, init
            character(len=1, kind=c_char) :: grid_major
            complex(c_double_complex) :: h(ldh, *), v(n, *)
            real(c_double) :: ritzv(*)
        end subroutine pzchase_init_pseudo_blockcyclic

        subroutine pzchase_init_pseudo_blockcyclic_internal(n, nev, nex, mbsize, nbsize, h, ldh, &
                dim0, dim1, grid_major, irsrc, icsrc, comm, init) &
            bind(c, name='pzchase_init_pseudo_blockcyclic_internal_')
            use iso_c_binding
            integer(c_int) :: n, nev, nex, mbsize, nbsize, ldh, dim0, dim1
            integer(c_int) :: irsrc, icsrc, comm, init
            character(len=1, kind=c_char) :: grid_major
            complex(c_double_complex) :: h(ldh, *)
        end subroutine pzchase_init_pseudo_blockcyclic_internal

        subroutine schase(deg, tol, mode, opt, qr) &
            bind(c, name='schase_')
            use iso_c_binding
            integer(c_int) :: deg
            real(c_float) :: tol
            character(len=1, kind=c_char) :: mode, opt, qr
        end subroutine schase

        subroutine pschase(deg, tol, mode, opt, qr) &
            bind(c, name='pschase_')
            use iso_c_binding
            integer(c_int) :: deg
            real(c_float) :: tol
            character(len=1, kind=c_char) :: mode, opt, qr
        end subroutine pschase

        subroutine dchase(deg, tol, mode, opt, qr) &
            bind(c, name='dchase_')
            use iso_c_binding
            integer(c_int) :: deg
            real(c_double) :: tol
            character(len=1, kind=c_char) :: mode, opt, qr
        end subroutine dchase

        subroutine pdchase(deg, tol, mode, opt, qr) &
            bind(c, name='pdchase_')
            use iso_c_binding
            integer(c_int) :: deg
            real(c_double) :: tol
            character(len=1, kind=c_char) :: mode, opt, qr
        end subroutine pdchase

        subroutine cchase(deg, tol, mode, opt, qr) &
            bind(c, name='cchase_')
            use iso_c_binding
            integer(c_int) :: deg
            real(c_float) :: tol
            character(len=1, kind=c_char) :: mode, opt, qr
        end subroutine cchase

        subroutine pcchase(deg, tol, mode, opt, qr) &
            bind(c, name='pcchase_')
            use iso_c_binding
            integer(c_int) :: deg
            real(c_float) :: tol
            character(len=1, kind=c_char) :: mode, opt, qr
        end subroutine pcchase

        subroutine zchase(deg, tol, mode, opt, qr) &
            bind(c, name='zchase_')
            use iso_c_binding
            integer(c_int) :: deg
            real(c_double) :: tol
            character(len=1, kind=c_char) :: mode, opt, qr
        end subroutine zchase

        subroutine pzchase(deg, tol, mode, opt, qr) &
            bind(c, name='pzchase_')
            use iso_c_binding
            integer(c_int) :: deg
            real(c_double) :: tol
            character(len=1, kind=c_char) :: mode, opt, qr
        end subroutine pzchase

        subroutine cchase_pseudo(deg, tol, mode, opt, qr) &
            bind(c, name='cchase_pseudo_')
            use iso_c_binding
            integer(c_int) :: deg
            real(c_float) :: tol
            character(len=1, kind=c_char) :: mode, opt, qr
        end subroutine cchase_pseudo

        subroutine zchase_pseudo(deg, tol, mode, opt, qr) &
            bind(c, name='zchase_pseudo_')
            use iso_c_binding
            integer(c_int) :: deg
            real(c_double) :: tol
            character(len=1, kind=c_char) :: mode, opt, qr
        end subroutine zchase_pseudo

        subroutine schase_get_eigenpairs(v, ld, ritzv) &
            bind(c, name='schase_get_eigenpairs_')
            use iso_c_binding
            integer(c_int) :: ld
            real(c_float) :: v(ld, *)
            real(c_float) :: ritzv(*)
        end subroutine schase_get_eigenpairs

        subroutine pschase_get_eigenpairs(v, ld, ritzv) &
            bind(c, name='pschase_get_eigenpairs_')
            use iso_c_binding
            integer(c_int) :: ld
            real(c_float) :: v(ld, *)
            real(c_float) :: ritzv(*)
        end subroutine pschase_get_eigenpairs

        subroutine dchase_get_eigenpairs(v, ld, ritzv) &
            bind(c, name='dchase_get_eigenpairs_')
            use iso_c_binding
            integer(c_int) :: ld
            real(c_double) :: v(ld, *)
            real(c_double) :: ritzv(*)
        end subroutine dchase_get_eigenpairs

        subroutine pdchase_get_eigenpairs(v, ld, ritzv) &
            bind(c, name='pdchase_get_eigenpairs_')
            use iso_c_binding
            integer(c_int) :: ld
            real(c_double) :: v(ld, *)
            real(c_double) :: ritzv(*)
        end subroutine pdchase_get_eigenpairs

        subroutine cchase_get_eigenpairs(v, ld, ritzv) &
            bind(c, name='cchase_get_eigenpairs_')
            use iso_c_binding
            integer(c_int) :: ld
            complex(c_float_complex) :: v(ld, *)
            real(c_float) :: ritzv(*)
        end subroutine cchase_get_eigenpairs

        subroutine pcchase_get_eigenpairs(v, ld, ritzv) &
            bind(c, name='pcchase_get_eigenpairs_')
            use iso_c_binding
            integer(c_int) :: ld
            complex(c_float_complex) :: v(ld, *)
            real(c_float) :: ritzv(*)
        end subroutine pcchase_get_eigenpairs

        subroutine zchase_get_eigenpairs(v, ld, ritzv) &
            bind(c, name='zchase_get_eigenpairs_')
            use iso_c_binding
            integer(c_int) :: ld
            complex(c_double_complex) :: v(ld, *)
            real(c_double) :: ritzv(*)
        end subroutine zchase_get_eigenpairs

        subroutine pzchase_get_eigenpairs(v, ld, ritzv) &
            bind(c, name='pzchase_get_eigenpairs_')
            use iso_c_binding
            integer(c_int) :: ld
            complex(c_double_complex) :: v(ld, *)
            real(c_double) :: ritzv(*)
        end subroutine pzchase_get_eigenpairs

        subroutine schase_finalize(flag) &
            bind(c, name='schase_finalize_')
            use iso_c_binding
            integer(c_int) :: flag
        end subroutine schase_finalize

        subroutine pschase_finalize(flag) &
            bind(c, name='pschase_finalize_')
            use iso_c_binding
            integer(c_int) :: flag
        end subroutine pschase_finalize

        subroutine dchase_finalize(flag) &
            bind(c, name='dchase_finalize_')
            use iso_c_binding
            integer(c_int) :: flag
        end subroutine dchase_finalize

        subroutine pdchase_finalize(flag) &
            bind(c, name='pdchase_finalize_')
            use iso_c_binding
            integer(c_int) :: flag
        end subroutine pdchase_finalize

        subroutine cchase_finalize(flag) &
            bind(c, name='cchase_finalize_')
            use iso_c_binding
            integer(c_int) :: flag
        end subroutine cchase_finalize

        subroutine pcchase_finalize(flag) &
            bind(c, name='pcchase_finalize_')
            use iso_c_binding
            integer(c_int) :: flag
        end subroutine pcchase_finalize

        subroutine zchase_finalize(flag) &
            bind(c, name='zchase_finalize_')
            use iso_c_binding
            integer(c_int) :: flag
        end subroutine zchase_finalize

        subroutine pzchase_finalize(flag) &
            bind(c, name='pzchase_finalize_')
            use iso_c_binding
            integer(c_int) :: flag
        end subroutine pzchase_finalize

        subroutine schase_read_ham(filename) &
            bind(c, name='schase_readHam_')
            use iso_c_binding
            character(kind=c_char) :: filename(*)
        end subroutine schase_read_ham

        subroutine pschase_read_ham(filename) &
            bind(c, name='pschase_readHam_')
            use iso_c_binding
            character(kind=c_char) :: filename(*)
        end subroutine pschase_read_ham

        subroutine dchase_read_ham(filename) &
            bind(c, name='dchase_readHam_')
            use iso_c_binding
            character(kind=c_char) :: filename(*)
        end subroutine dchase_read_ham

        subroutine pdchase_read_ham(filename) &
            bind(c, name='pdchase_readHam_')
            use iso_c_binding
            character(kind=c_char) :: filename(*)
        end subroutine pdchase_read_ham

        subroutine cchase_read_ham(filename) &
            bind(c, name='cchase_readHam_')
            use iso_c_binding
            character(kind=c_char) :: filename(*)
        end subroutine cchase_read_ham

        subroutine pcchase_read_ham(filename) &
            bind(c, name='pcchase_readHam_')
            use iso_c_binding
            character(kind=c_char) :: filename(*)
        end subroutine pcchase_read_ham

        subroutine zchase_read_ham(filename) &
            bind(c, name='zchase_readHam_')
            use iso_c_binding
            character(kind=c_char) :: filename(*)
        end subroutine zchase_read_ham

        subroutine pzchase_read_ham(filename) &
            bind(c, name='pzchase_readHam_')
            use iso_c_binding
            character(kind=c_char) :: filename(*)
        end subroutine pzchase_read_ham

        subroutine pschase_wrt_ham(filename) &
            bind(c, name='pschase_wrtHam_')
            use iso_c_binding
            character(kind=c_char) :: filename(*)
        end subroutine pschase_wrt_ham

        subroutine pdchase_wrt_ham(filename) &
            bind(c, name='pdchase_wrtHam_')
            use iso_c_binding
            character(kind=c_char) :: filename(*)
        end subroutine pdchase_wrt_ham

        subroutine pcchase_wrt_ham(filename) &
            bind(c, name='pcchase_wrtHam_')
            use iso_c_binding
            character(kind=c_char) :: filename(*)
        end subroutine pcchase_wrt_ham

        subroutine pzchase_wrt_ham(filename) &
            bind(c, name='pzchase_wrtHam_')
            use iso_c_binding
            character(kind=c_char) :: filename(*)
        end subroutine pzchase_wrt_ham

        subroutine chase_set_tol(tol) &
            bind(c, name='chase_set_tol_')
            use iso_c_binding
            real(c_double) :: tol
        end subroutine chase_set_tol

        subroutine chase_set_deg(n) &
            bind(c, name='chase_set_deg_')
            use iso_c_binding
            integer(c_int) :: n
        end subroutine chase_set_deg

        subroutine chase_set_max_iter(n) &
            bind(c, name='chase_set_max_iter_')
            use iso_c_binding
            integer(c_int) :: n
        end subroutine chase_set_max_iter

        subroutine chase_set_opt(n) &
            bind(c, name='chase_set_opt_')
            use iso_c_binding
            integer(c_int) :: n
        end subroutine chase_set_opt

        subroutine chase_set_lanczos_iter(n) &
            bind(c, name='chase_set_lanczos_iter_')
            use iso_c_binding
            integer(c_int) :: n
        end subroutine chase_set_lanczos_iter

        subroutine chase_set_num_lanczos(n) &
            bind(c, name='chase_set_num_lanczos_')
            use iso_c_binding
            integer(c_int) :: n
        end subroutine chase_set_num_lanczos

        subroutine chase_set_max_deg(n) &
            bind(c, name='chase_set_max_deg_')
            use iso_c_binding
            integer(c_int) :: n
        end subroutine chase_set_max_deg

        subroutine chase_set_deg_extra(n) &
            bind(c, name='chase_set_deg_extra_')
            use iso_c_binding
            integer(c_int) :: n
        end subroutine chase_set_deg_extra

        subroutine chase_set_approx(n) &
            bind(c, name='chase_set_approx_')
            use iso_c_binding
            integer(c_int) :: n
        end subroutine chase_set_approx

        subroutine chase_set_cholqr(n) &
            bind(c, name='chase_set_cholqr_')
            use iso_c_binding
            integer(c_int) :: n
        end subroutine chase_set_cholqr

        subroutine chase_enable_sym_check(n) &
            bind(c, name='chase_enable_sym_check_')
            use iso_c_binding
            integer(c_int) :: n
        end subroutine chase_enable_sym_check

        subroutine chase_set_cluster_aware_degrees(n) &
            bind(c, name='chase_set_cluster_aware_degrees_')
            use iso_c_binding
            integer(c_int) :: n
        end subroutine chase_set_cluster_aware_degrees

        subroutine chase_set_decaying_rate(rate) &
            bind(c, name='chase_set_decaying_rate_')
            use iso_c_binding
            real(c_float) :: rate
        end subroutine chase_set_decaying_rate

        subroutine chase_set_upperb_scale_rate(rate) &
            bind(c, name='chase_set_upperb_scale_rate_')
            use iso_c_binding
            real(c_float) :: rate
        end subroutine chase_set_upperb_scale_rate

        subroutine chase_has_cuda(flag) &
            bind(c, name='chase_has_cuda_')
            use iso_c_binding
            integer(c_int) :: flag
        end subroutine chase_has_cuda

        subroutine chase_has_nccl(flag) &
            bind(c, name='chase_has_nccl_')
            use iso_c_binding
            integer(c_int) :: flag
        end subroutine chase_has_nccl

        subroutine chase_has_scalapack(flag) &
            bind(c, name='chase_has_scalapack_')
            use iso_c_binding
            integer(c_int) :: flag
        end subroutine chase_has_scalapack

        subroutine chase_has_mpi(flag) &
            bind(c, name='chase_has_mpi_')
            use iso_c_binding
            integer(c_int) :: flag
        end subroutine chase_has_mpi

        subroutine chase_get_version(version, length) &
            bind(c, name='chase_get_version_')
            use iso_c_binding
            character(kind=c_char) :: version(*)
            integer(c_int) :: length
        end subroutine chase_get_version

        subroutine chase_print_config() bind(c, name='chase_print_config_')
        end subroutine chase_print_config
    end interface
end module chase_tpu_interface
