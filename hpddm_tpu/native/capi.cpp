// Exportable C ABI for the JAX runtime — the analogue of the reference's
// interface/HPDDM.h:66-123 (HpddmOption*/HpddmMatrixCSR*/HpddmSubdomain*/
// HpddmSchwarz*/HpddmSolve).  The numerics run in the embedded CPython
// interpreter (JAX owns the device); this shim is the stable C surface: it
// forwards raw pointers to hpddm_tpu.capi_host, which wraps them as
// zero-copy numpy views.  K = double on this side of the boundary; the
// device dtype follows the backend.
//
// Build: make -C hpddm_tpu/native capi   ->  libhpddm_tpu_c.so
// Link:  cc app.c -lhpddm_tpu_c -lpython3.12
#include <Python.h>

#include <cstdarg>
#include <cstdio>

extern "C" {

static PyObject *g_mod = nullptr;

static long long call_ll(const char *fn, const char *fmt, ...) {
  if (!g_mod) return -1;
  PyGILState_STATE st = PyGILState_Ensure();
  va_list ap;
  va_start(ap, fmt);
  PyObject *args = Py_VaBuildValue(fmt, ap);
  va_end(ap);
  long long out = -1;
  if (args) {
    PyObject *f = PyObject_GetAttrString(g_mod, fn);
    if (f) {
      PyObject *r = PyObject_CallObject(f, args);
      if (r) {
        out = PyLong_AsLongLong(r);
        Py_DECREF(r);
      }
      Py_DECREF(f);
    }
    Py_DECREF(args);
  }
  if (PyErr_Occurred()) {
    PyErr_Print();
    out = -1;
  }
  PyGILState_Release(st);
  return out;
}

int HpddmTpuInit(void) {
  if (!Py_IsInitialized()) Py_InitializeEx(0);
  PyGILState_STATE st = PyGILState_Ensure();
  if (!g_mod) g_mod = PyImport_ImportModule("hpddm_tpu.capi_host");
  int ok = g_mod ? 0 : -1;
  if (!g_mod) PyErr_Print();
  PyGILState_Release(st);
  return ok;
}

void HpddmTpuFinalize(void) {
  // leave the interpreter up: JAX runtimes do not survive re-init
}

int HpddmTpuOptionSet(const char *text) {
  return (int)call_ll("option_set", "(s)", text);
}

double HpddmTpuOptionVal(const char *key) {
  if (!g_mod) return -1.0;
  PyGILState_STATE st = PyGILState_Ensure();
  double out = -1.0;
  PyObject *r = PyObject_CallMethod(g_mod, "option_val", "(s)", key);
  if (r) {
    out = PyFloat_AsDouble(r);
    Py_DECREF(r);
  } else {
    PyErr_Print();
  }
  PyGILState_Release(st);
  return out;
}

// ---------------------------------------------------------------- matrix
long long HpddmTpuMatrixCSRCreate(int n, int m, int nnz, double *a,
                                  int *ia, int *ja, int sym) {
  return call_ll("matrix_create", "(iiiLLLi)", n, m, nnz,
                 (long long)a, (long long)ia, (long long)ja, sym);
}

void HpddmTpuMatrixCSRDestroy(long long h) {
  call_ll("matrix_destroy", "(L)", h);
}

void HpddmTpuCSRMM(long long h, const double *x, double *y, int mu) {
  call_ll("csrmm", "(LLLi)", h, (long long)x, (long long)y, mu);
}

// ------------------------------------------------------------- subdomain
long long HpddmTpuSubdomainNumfact(long long h_mat) {
  return call_ll("subdomain_numfact", "(L)", h_mat);
}

void HpddmTpuSubdomainSolve(long long h, const double *b, double *x,
                            int mu) {
  call_ll("subdomain_solve", "(LLLi)", h, (long long)b, (long long)x, mu);
}

void HpddmTpuSubdomainDestroy(long long h) {
  call_ll("subdomain_destroy", "(L)", h);
}

// --------------------------------------------------------------- schwarz
long long HpddmTpuSchwarzCreate(int S) {
  return call_ll("schwarz_create", "(i)", S);
}

int HpddmTpuSchwarzSetSubdomain(long long h, int s, long long h_mat,
                                int nnbr, int *nbrs, int *map_sizes,
                                int *maps_flat, double *d) {
  return (int)call_ll("schwarz_set_subdomain", "(LiLiLLLL)", h, s, h_mat,
                      nnbr, (long long)nbrs, (long long)map_sizes,
                      (long long)maps_flat, (long long)d);
}

int HpddmTpuSchwarzSetNeumann(long long h, int s, long long h_mat) {
  return (int)call_ll("schwarz_set_neumann", "(LiL)", h, s, h_mat);
}

int HpddmTpuSchwarzBuild(long long h) {
  return (int)call_ll("schwarz_build", "(L)", h);
}

static PyObject *ptr_list(void **ptrs, int S) {
  PyObject *l = PyList_New(S);
  for (int s = 0; s < S; ++s)
    PyList_SetItem(l, s, PyLong_FromLongLong((long long)ptrs[s]));
  return l;
}

int HpddmTpuSolve(long long h, double **f, double **x, int S, int mu) {
  if (!g_mod) return -1;
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject *fl = ptr_list((void **)f, S);
  PyObject *xl = ptr_list((void **)x, S);
  int out = -1;
  PyObject *r = PyObject_CallMethod(g_mod, "schwarz_solve", "(LOOi)", h,
                                    fl, xl, mu);
  if (r) {
    out = (int)PyLong_AsLongLong(r);
    Py_DECREF(r);
  } else {
    PyErr_Print();
  }
  Py_DECREF(fl);
  Py_DECREF(xl);
  PyGILState_Release(st);
  return out;
}

int HpddmTpuSchwarzComputeResidual(long long h, double **x, double **f,
                                   double *out, int S, int mu) {
  if (!g_mod) return -1;
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject *xl = ptr_list((void **)x, S);
  PyObject *fl = ptr_list((void **)f, S);
  int ok = -1;
  PyObject *r = PyObject_CallMethod(g_mod, "schwarz_residual", "(LOOLi)",
                                    h, xl, fl, (long long)out, mu);
  if (r) {
    ok = (int)PyLong_AsLongLong(r);
    Py_DECREF(r);
  } else {
    PyErr_Print();
  }
  Py_DECREF(xl);
  Py_DECREF(fl);
  PyGILState_Release(st);
  return ok;
}

void HpddmTpuSchwarzDestroy(long long h) {
  call_ll("schwarz_destroy", "(L)", h);
}

}  // extern "C"
