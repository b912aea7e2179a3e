// libchase_tpu — C ABI with the reference's symbol names and signatures
// (interface/chase_c_interface.h: {s,d,c,z}chase_init_, *chase_,
// *chase_get_eigenpairs_, *chase_finalize_, chase_set_*, chase_has_*),
// implemented by embedding CPython and driving chase_tpu.interface.
//
// Existing C / Fortran applications written against ChASE's C interface
// (FLEUR, YAMBO-style call patterns) relink against this library unchanged;
// the trailing-underscore, pointer-argument convention matches Fortran
// iso_c_binding expectations.  The distributed p*chase_* entry points map
// to the same implementation with the device grid enabled (the MPI
// communicator argument is accepted and ignored: process-level MPI is
// replaced by the in-process device mesh).
//
// Build:  g++ -O3 -shared -fPIC chase_capi.cpp $(python3-config --includes)
//             $(python3-config --ldflags --embed) -o libchase_tpu.so

#include <Python.h>

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

namespace {

PyObject* g_ns = nullptr;   // namespace dict for the embedded prelude

const char* kPrelude = R"PY(
import os, ctypes
import numpy as np
_plat = os.environ.get('CHASE_TPU_PLATFORM')
if _plat:
    import jax
    jax.config.update('jax_platforms', _plat)
import chase_tpu.interface as _iface
from chase_tpu.device import use_compile_cache
use_compile_cache()

_state = {}

def _view(ptr, rows, cols, ld, dt):
    dt = np.dtype(dt)
    buf = (ctypes.c_char * (ld * cols * dt.itemsize)).from_address(ptr)
    a = np.frombuffer(buf, dtype=dt)
    return a.reshape(cols, ld).T[:rows]      # column-major (rows, cols) view

def capi_init(ptrH, ptrV, ptrR, N, nev, nex, ldh, dt, rdt, pseudo, dist):
    H = _view(ptrH, N, N, ldh, dt)
    cols = 2 * (nev + nex) if pseudo else (nev + nex)
    V = _view(ptrV, N, cols, N, dt).copy() if ptrV else None
    R = None
    if ptrR:
        rdt_ = np.dtype(rdt)
        buf = (ctypes.c_char * (cols * rdt_.itemsize)).from_address(ptrR)
        R = np.frombuffer(buf, dtype=rdt_).copy()
    if pseudo:
        _iface.init_pseudo(N, nev, nex, H, distributed=bool(dist))
        _iface._require().V0 = V
        _iface._require().ritzv0 = None if R is None else R.astype('float64')
    else:
        _iface.init(N, nev, nex, H, V, R, distributed=bool(dist))
    _state.update(ptrV=ptrV, ptrR=ptrR, dt=dt, rdt=rdt, N=N, nev=nev,
                  nex=nex, pseudo=pseudo, mloc=None)
    return 0

def capi_init_dist(ptrH, ptrV, ptrR, N, nev, nex, m, n, ldh, dt, rdt,
                   pseudo, dim0, dim1, major, mb, nb, irsrc=0, icsrc=0):
    # Reference p*chase_init_* pass each rank's LOCAL (m, n) block
    # (chase_c_interface.h:126-157).  Two modes:
    #   * single process owning the full matrix (m == n == N): the
    #     dim0 x dim1 grid is the in-process DEVICE mesh;
    #   * one jax.distributed process per MPI rank (local (m, n) block):
    #     requires the coordinator env (JAX_COORDINATOR_ADDRESS +
    #     JAX_NUM_PROCESSES + JAX_PROCESS_ID, typically exported from the
    #     MPI launcher) — the blocks assemble into one global sharded
    #     array and the solve runs SPMD across all callers.
    if m != N or n != N:
        from chase_tpu.parallel import multihost
        multihost.ensure_initialized()
        import jax
        if jax.process_count() != dim0 * dim1:
            raise ValueError(
                f"local block ({m}, {n}) != ({N}, {N}) needs one "
                f"jax.distributed process per rank: grid {dim0}x{dim1} "
                f"vs process_count {jax.process_count()} — export "
                f"JAX_COORDINATOR_ADDRESS/JAX_NUM_PROCESSES/"
                f"JAX_PROCESS_ID (or pass the full matrix from one "
                f"process)")
        if mb > 0:
            raise ValueError("per-rank block-cyclic init is not supported "
                             "(use the block-block p*chase_init_)")
        Hl = _view(ptrH, m, n, ldh, dt).copy()
        cols = 2 * (nev + nex) if pseudo else (nev + nex)
        Vl = _view(ptrV, m, cols, m, dt).copy() if ptrV else None
        R = None
        if ptrR:
            rdt_ = np.dtype(rdt)
            buf = (ctypes.c_char * (cols * rdt_.itemsize)).from_address(ptrR)
            R = np.frombuffer(buf, dtype=rdt_).copy().astype('float64')
        _iface.init_dist_local(N, nev, nex, m, n, Hl, Vl, R,
                               grid_shape=(dim0, dim1), grid_major=major,
                               pseudo=bool(pseudo))
        _state.update(ptrV=ptrV, ptrR=ptrR, dt=dt, rdt=rdt, N=N, nev=nev,
                      nex=nex, pseudo=pseudo, mloc=m)
        return 0
    H = _view(ptrH, N, N, ldh, dt)
    cols = 2 * (nev + nex) if pseudo else (nev + nex)
    V = _view(ptrV, N, cols, N, dt).copy() if ptrV else None
    R = None
    if ptrR:
        rdt_ = np.dtype(rdt)
        buf = (ctypes.c_char * (cols * rdt_.itemsize)).from_address(ptrR)
        R = np.frombuffer(buf, dtype=rdt_).copy().astype('float64')
    gs = (dim0, dim1)
    if mb > 0:
        _iface.init_blockcyclic(N, nev, nex, mb, nb, H, V,
                                None if pseudo else R, pseudo=bool(pseudo),
                                grid_shape=gs, grid_major=major,
                                irsrc=irsrc, icsrc=icsrc)
    elif pseudo:
        _iface.init_pseudo(N, nev, nex, H, V, distributed=True,
                           grid_shape=gs, grid_major=major)
    else:
        _iface.init(N, nev, nex, H, V, R, distributed=True,
                    grid_shape=gs, grid_major=major)
    if pseudo:
        _iface._require().ritzv0 = R
    _state.update(ptrV=ptrV, ptrR=ptrR, dt=dt, rdt=rdt, N=N, nev=nev,
                  nex=nex, pseudo=pseudo, mloc=None)
    return 0

def capi_solve(deg, tol, mode, opt, qr):
    return _iface.solve(deg if deg > 0 else None,
                        tol if tol > 0 else None, mode, opt, qr)

def capi_get(ptrV, ld, ptrR):
    evals, evecs = _iface.get_eigenpairs()
    N, nev = _state['N'], _state['nev']
    # per-rank mode: the caller's buffer holds ITS (mloc, nev) row block
    rows = _state.get('mloc') or N
    ptrV = ptrV or _state['ptrV']
    ptrR = ptrR or _state['ptrR']
    if ptrV:
        _view(ptrV, rows, nev, ld if ld > 0 else rows,
              _state['dt'])[:] = evecs
    if ptrR:
        rdt = np.dtype(_state['rdt'])
        buf = (ctypes.c_char * (nev * rdt.itemsize)).from_address(ptrR)
        np.frombuffer(buf, dtype=rdt)[:nev] = evals
    return 0

def capi_finalize(flag):
    return _iface.finalize(flag)

def capi_set(name, value):
    getattr(_iface, 'set_' + name)(value)
    return 0

def capi_read_ham(path):
    import chase_tpu.io as _io
    s = _iface._require()
    s.H = _io.load_matrix(path, s.N, s.H.dtype)
    s.H_owned = None   # invalidate the memoized layout-permuted copy
    return 0

def capi_write_ham(path):
    import chase_tpu.io as _io
    s = _iface._require()
    _io.save_matrix(s.H, path)
    return 0
)PY";

bool ensure_py() {
    if (g_ns) return true;
    if (!Py_IsInitialized()) Py_InitializeEx(0);
    PyObject* main_mod = PyImport_AddModule("__main__");
    g_ns = PyModule_GetDict(main_mod);
    Py_XINCREF(g_ns);
    PyObject* r = PyRun_String(kPrelude, Py_file_input, g_ns, g_ns);
    if (!r) {
        PyErr_Print();
        g_ns = nullptr;
        return false;
    }
    Py_DECREF(r);
    return true;
}

int run(const std::string& code) {
    if (!ensure_py()) return -1;
    PyObject* r = PyRun_String(code.c_str(), Py_eval_input, g_ns, g_ns);
    if (!r) {
        PyErr_Print();
        return -1;
    }
    long v = PyLong_Check(r) ? PyLong_AsLong(r) : 0;
    Py_DECREF(r);
    return static_cast<int>(v);
}

std::string fmt(const char* f, ...) {
    char buf[1024];
    va_list ap;
    va_start(ap, f);
    vsnprintf(buf, sizeof(buf), f, ap);
    va_end(ap);
    return std::string(buf);
}

int do_init(const void* H, const void* V, const void* ritzv, int N, int nev,
            int nex, int ldh, const char* dt, const char* rdt, int pseudo,
            int dist) {
    return run(fmt(
        "capi_init(%llu, %llu, %llu, %d, %d, %d, %d, '%s', '%s', %d, %d)",
        (unsigned long long)(uintptr_t)H, (unsigned long long)(uintptr_t)V,
        (unsigned long long)(uintptr_t)ritzv, N, nev, nex, ldh, dt, rdt,
        pseudo, dist));
}

int do_solve(int deg, double tol, char mode, char opt, char qr) {
    return run(fmt("capi_solve(%d, %.17g, '%c', '%c', '%c')",
                   deg, tol, mode, opt, qr));
}

// distributed init with the reference's full signature: (m, n) local block
// dims, (dim0, dim1) grid, grid_major, ignored MPI communicator; mb/nb > 0
// selects the block-cyclic layout (chase_c_interface.h:61-157).
int do_init_dist(const void* H, const void* V, const void* ritzv, int N,
                 int nev, int nex, int m, int n, int ldh, const char* dt,
                 const char* rdt, int pseudo, int dim0, int dim1,
                 char major, int mb, int nb, int irsrc, int icsrc) {
    return run(fmt(
        "capi_init_dist(%llu, %llu, %llu, %d, %d, %d, %d, %d, %d, '%s', "
        "'%s', %d, %d, %d, '%c', %d, %d, %d, %d)",
        (unsigned long long)(uintptr_t)H, (unsigned long long)(uintptr_t)V,
        (unsigned long long)(uintptr_t)ritzv, N, nev, nex, m, n, ldh, dt,
        rdt, pseudo, dim0, dim1, major, mb, nb, irsrc, icsrc));
}

}  // namespace

#define INIT_FN(prefix, T, DT, RDT, PSEUDO, DIST)                           \
    extern "C" void prefix(int* N, int* nev, int* nex, T* H, int* ldh,      \
                           T* V, RDT_TYPE* ritzv, int* init) {              \
        (void)init;                                                         \
        do_init(H, V, ritzv, *N, *nev, *nex, *ldh, DT, RDT, PSEUDO, DIST);  \
    }

// serial init without user-provided V/ritzv: the library allocates the
// search space internally; eigenpairs come back through the caller's
// buffers in *chase_get_eigenpairs_ (chase_c_interface.h:25-32, 49-55)
#define INIT_INT_FN(prefix, T, DT, RDT, PSEUDO)                             \
    extern "C" void prefix(int* N, int* nev, int* nex, T* H, int* ldh,      \
                           int* init) {                                     \
        (void)init;                                                         \
        do_init(H, nullptr, nullptr, *N, *nev, *nex, *ldh, DT, RDT,         \
                PSEUDO, 0);                                                 \
    }

// distributed block-block init — reference signature with local (m, n)
// dims, (dim0, dim1) grid, grid_major, MPI communicator (accepted and
// ignored: the process grid is the in-process device mesh)
// (chase_c_interface.h:126-157)
#define PINIT_FN(prefix, T, DT, RDT, PSEUDO)                                \
    extern "C" void prefix(int* N, int* nev, int* nex, int* m, int* n,      \
                           T* H, int* ldh, T* V, RDT_TYPE* ritzv,           \
                           int* dim0, int* dim1, char* grid_major,          \
                           void* comm, int* init) {                         \
        (void)comm; (void)init;                                             \
        do_init_dist(H, V, ritzv, *N, *nev, *nex, *m, *n, *ldh, DT, RDT,    \
                     PSEUDO, *dim0, *dim1,                                  \
                     grid_major ? *grid_major : 'R', 0, 0, 0, 0);           \
    }

#define PINIT_INT_FN(prefix, T, DT, RDT, PSEUDO)                            \
    extern "C" void prefix(int* N, int* nev, int* nex, int* m, int* n,      \
                           T* H, int* ldh, int* dim0, int* dim1,            \
                           char* grid_major, void* comm, int* init) {       \
        (void)comm; (void)init;                                             \
        do_init_dist(H, nullptr, nullptr, *N, *nev, *nex, *m, *n, *ldh,     \
                     DT, RDT, PSEUDO, *dim0, *dim1,                         \
                     grid_major ? *grid_major : 'R', 0, 0, 0, 0);           \
    }

// distributed block-cyclic init (mbsize × nbsize ScaLAPACK-style blocks;
// irsrc/icsrc source offsets) (chase_c_interface.h:61-121)
#define PINIT_BC_FN(prefix, T, DT, RDT, PSEUDO)                             \
    extern "C" void prefix(int* N, int* nev, int* nex, int* mbsize,         \
                           int* nbsize, T* H, int* ldh, T* V,               \
                           RDT_TYPE* ritzv, int* dim0, int* dim1,           \
                           char* grid_major, int* irsrc, int* icsrc,        \
                           void* comm, int* init) {                         \
        (void)comm; (void)init;                                             \
        do_init_dist(H, V, ritzv, *N, *nev, *nex, *N, *N, *ldh, DT, RDT,    \
                     PSEUDO, *dim0, *dim1,                                  \
                     grid_major ? *grid_major : 'R', *mbsize, *nbsize,      \
                     irsrc ? *irsrc : 0, icsrc ? *icsrc : 0);               \
    }

#define PINIT_BC_INT_FN(prefix, T, DT, RDT, PSEUDO)                         \
    extern "C" void prefix(int* N, int* nev, int* nex, int* mbsize,         \
                           int* nbsize, T* H, int* ldh, int* dim0,          \
                           int* dim1, char* grid_major, int* irsrc,         \
                           int* icsrc, void* comm, int* init) {             \
        (void)comm; (void)init;                                             \
        do_init_dist(H, nullptr, nullptr, *N, *nev, *nex, *N, *N, *ldh,     \
                     DT, RDT, PSEUDO, *dim0, *dim1,                         \
                     grid_major ? *grid_major : 'R', *mbsize, *nbsize,      \
                     irsrc ? *irsrc : 0, icsrc ? *icsrc : 0);               \
    }

#define RDT_TYPE float
INIT_FN(schase_init_, float, "float32", "float32", 0, 0)
INIT_FN(cchase_init_, void, "complex64", "float32", 0, 0)
INIT_FN(cchase_init_pseudo_, void, "complex64", "float32", 1, 0)
INIT_INT_FN(schase_init_internal_, float, "float32", "float32", 0)
INIT_INT_FN(cchase_init_internal_, void, "complex64", "float32", 0)
INIT_INT_FN(cchase_init_pseudo_internal_, void, "complex64", "float32", 1)
PINIT_FN(pschase_init_, float, "float32", "float32", 0)
PINIT_FN(pcchase_init_, void, "complex64", "float32", 0)
PINIT_FN(pcchase_init_pseudo_, void, "complex64", "float32", 1)
PINIT_INT_FN(pschase_init_internal_, float, "float32", "float32", 0)
PINIT_INT_FN(pcchase_init_internal_, void, "complex64", "float32", 0)
PINIT_INT_FN(pcchase_init_pseudo_internal_, void, "complex64", "float32", 1)
PINIT_BC_FN(pschase_init_blockcyclic_, float, "float32", "float32", 0)
PINIT_BC_FN(pcchase_init_blockcyclic_, void, "complex64", "float32", 0)
PINIT_BC_FN(pcchase_init_pseudo_blockcyclic_, void, "complex64", "float32", 1)
PINIT_BC_INT_FN(pschase_init_blockcyclic_internal_, float, "float32",
                "float32", 0)
PINIT_BC_INT_FN(pcchase_init_blockcyclic_internal_, void, "complex64",
                "float32", 0)
PINIT_BC_INT_FN(pcchase_init_pseudo_blockcyclic_internal_, void, "complex64",
                "float32", 1)
#undef RDT_TYPE
#define RDT_TYPE double
INIT_FN(dchase_init_, double, "float64", "float64", 0, 0)
INIT_FN(zchase_init_, void, "complex128", "float64", 0, 0)
INIT_FN(zchase_init_pseudo_, void, "complex128", "float64", 1, 0)
INIT_INT_FN(dchase_init_internal_, double, "float64", "float64", 0)
INIT_INT_FN(zchase_init_internal_, void, "complex128", "float64", 0)
INIT_INT_FN(zchase_init_pseudo_internal_, void, "complex128", "float64", 1)
PINIT_FN(pdchase_init_, double, "float64", "float64", 0)
PINIT_FN(pzchase_init_, void, "complex128", "float64", 0)
PINIT_FN(pzchase_init_pseudo_, void, "complex128", "float64", 1)
PINIT_INT_FN(pdchase_init_internal_, double, "float64", "float64", 0)
PINIT_INT_FN(pzchase_init_internal_, void, "complex128", "float64", 0)
PINIT_INT_FN(pzchase_init_pseudo_internal_, void, "complex128", "float64", 1)
PINIT_BC_FN(pdchase_init_blockcyclic_, double, "float64", "float64", 0)
PINIT_BC_FN(pzchase_init_blockcyclic_, void, "complex128", "float64", 0)
PINIT_BC_FN(pzchase_init_pseudo_blockcyclic_, void, "complex128", "float64", 1)
PINIT_BC_INT_FN(pdchase_init_blockcyclic_internal_, double, "float64",
                "float64", 0)
PINIT_BC_INT_FN(pzchase_init_blockcyclic_internal_, void, "complex128",
                "float64", 0)
PINIT_BC_INT_FN(pzchase_init_pseudo_blockcyclic_internal_, void,
                "complex128", "float64", 1)
#undef RDT_TYPE

#define SOLVE_FN(prefix, TOL_T)                                             \
    extern "C" void prefix(int* deg, TOL_T* tol, char* mode, char* opt,     \
                           char* qr) {                                      \
        do_solve(deg ? *deg : 0, tol ? (double)*tol : 0.0,                  \
                 mode ? *mode : 'R', opt ? *opt : 'S', qr ? *qr : 'C');     \
    }

SOLVE_FN(dchase_, double)
SOLVE_FN(schase_, float)
SOLVE_FN(zchase_, double)
SOLVE_FN(cchase_, float)
SOLVE_FN(zchase_pseudo_, double)
SOLVE_FN(cchase_pseudo_, float)
SOLVE_FN(pdchase_, double)
SOLVE_FN(pschase_, float)
SOLVE_FN(pzchase_, double)
SOLVE_FN(pcchase_, float)

#define GET_FN(prefix, T, RT)                                               \
    extern "C" void prefix(T* LEigsV, int* ld, RT* ritzv) {                 \
        run(fmt("capi_get(%llu, %d, %llu)",                                 \
                (unsigned long long)(uintptr_t)LEigsV, ld ? *ld : 0,        \
                (unsigned long long)(uintptr_t)ritzv));                     \
    }

GET_FN(dchase_get_eigenpairs_, double, double)
GET_FN(schase_get_eigenpairs_, float, float)
GET_FN(zchase_get_eigenpairs_, void, double)
GET_FN(cchase_get_eigenpairs_, void, float)
GET_FN(pdchase_get_eigenpairs_, double, double)
GET_FN(pschase_get_eigenpairs_, float, float)
GET_FN(pzchase_get_eigenpairs_, void, double)
GET_FN(pcchase_get_eigenpairs_, void, float)

#define FIN_FN(prefix)                                                      \
    extern "C" void prefix(int* flag) {                                     \
        run(fmt("capi_finalize(%d)", flag ? *flag : 0));                    \
    }

FIN_FN(dchase_finalize_)
FIN_FN(schase_finalize_)
FIN_FN(zchase_finalize_)
FIN_FN(cchase_finalize_)
FIN_FN(pdchase_finalize_)
FIN_FN(pschase_finalize_)
FIN_FN(pzchase_finalize_)
FIN_FN(pcchase_finalize_)

#define HAM_FN(prefix, CALL)                                                \
    extern "C" void prefix(const char* filename) {                          \
        run(fmt(CALL "('%s')", filename));                                  \
    }

HAM_FN(pdchase_readHam_, "capi_read_ham")
HAM_FN(pschase_readHam_, "capi_read_ham")
HAM_FN(pcchase_readHam_, "capi_read_ham")
HAM_FN(pzchase_readHam_, "capi_read_ham")
HAM_FN(dchase_readHam_, "capi_read_ham")
HAM_FN(schase_readHam_, "capi_read_ham")
HAM_FN(cchase_readHam_, "capi_read_ham")
HAM_FN(zchase_readHam_, "capi_read_ham")
HAM_FN(pdchase_wrtHam_, "capi_write_ham")
HAM_FN(pschase_wrtHam_, "capi_write_ham")
HAM_FN(pcchase_wrtHam_, "capi_write_ham")
HAM_FN(pzchase_wrtHam_, "capi_write_ham")

// unified config setters (chase_c_interface.h:217-230)
extern "C" void chase_set_tol_(double* tol) {
    run(fmt("capi_set('tol', %.17g)", *tol));
}
extern "C" void chase_set_deg_(int* deg) {
    run(fmt("capi_set('deg', %d)", *deg));
}
extern "C" void chase_set_max_iter_(int* n) {
    run(fmt("capi_set('maxiter', %d)", *n));
}
extern "C" void chase_set_opt_(int* flag) {
    run(fmt("capi_set('opt', %d)", *flag));
}
extern "C" void chase_set_lanczos_iter_(int* n) {
    run(fmt("_iface.set_lanczos(%d, _iface._require().config.num_lanczos) or 0",
            *n));
}
extern "C" void chase_set_num_lanczos_(int* n) {
    run(fmt("_iface.set_lanczos(_iface._require().config.lanczos_iter or 25,"
            " %d) or 0", *n));
}

extern "C" void chase_set_max_deg_(int* n) {
    run(fmt("capi_set('max_deg', %d)", *n));
}
extern "C" void chase_set_deg_extra_(int* n) {
    run(fmt("capi_set('deg_extra', %d)", *n));
}
extern "C" void chase_set_approx_(int* flag) {
    run(fmt("capi_set('approx', %d)", *flag));
}
extern "C" void chase_set_cholqr_(int* flag) {
    run(fmt("capi_set('cholqr', %d)", *flag));
}
extern "C" void chase_enable_sym_check_(int* flag) {
    run(fmt("_iface.enable_sym_check(%d) or 0", *flag));
}
extern "C" void chase_set_decaying_rate_(float* rate) {
    run(fmt("capi_set('decaying_rate', %.9g)", (double)*rate));
}
extern "C" void chase_set_cluster_aware_degrees_(int* flag) {
    run(fmt("capi_set('cluster_aware_degrees', %d)", *flag));
}
extern "C" void chase_set_upperb_scale_rate_(float* rate) {
    run(fmt("capi_set('upperb_scale_rate', %.9g)", (double)*rate));
}

// build introspection (chase_c_interface.h:234-239)
extern "C" void chase_has_cuda_(int* flag) {
    *flag = run("1 if _iface.has_gpu() else 0");
}
extern "C" void chase_has_nccl_(int* flag) { *flag = 0; }
extern "C" void chase_has_scalapack_(int* flag) { *flag = 0; }
extern "C" void chase_has_mpi_(int* flag) { *flag = 0; }
extern "C" void chase_get_version_(char* version, int* len) {
    const char* v = "chase_tpu-0.1.0";
    int n = (int)strlen(v);
    if (*len > n) {
        memcpy(version, v, n + 1);
        *len = n;
    } else {
        memcpy(version, v, *len);
    }
}
extern "C" void chase_print_config_() {
    printf("chase_tpu: JAX/XLA build (CPU or GPU); C ABI via embedded "
           "Python\n");
}
