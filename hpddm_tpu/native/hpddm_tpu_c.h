/* Exportable C ABI for the hpddm_tpu runtime — analogue of the
 * reference's interface/HPDDM.h:66-123.  K = double at this boundary;
 * the device computes in the backend dtype (f32 on the GPU).
 *
 * Usage:
 *   HpddmTpuInit();                       // boots embedded CPython + JAX
 *   h = HpddmTpuMatrixCSRCreate(...);     // 0-based CSR
 *   s = HpddmTpuSchwarzCreate(S);         // whole decomposition, batched
 *   HpddmTpuSchwarzSetSubdomain(s, i, h_i, ...);
 *   HpddmTpuSchwarzBuild(s);              // numfact (+GEVP/coarse if set)
 *   its = HpddmTpuSolve(s, f, x, S, mu);  // per-subdomain buffers
 *
 * Handles are opaque int64 (negative on error).  The caller must set
 * PYTHONPATH so that `import hpddm_tpu` works in the embedded
 * interpreter, and link against libpython (see native/Makefile `capi`).
 */
#ifndef HPDDM_TPU_C_H
#define HPDDM_TPU_C_H

#ifdef __cplusplus
extern "C" {
#endif

int HpddmTpuInit(void);
void HpddmTpuFinalize(void);

/* "-hpddm_key value ..." strings (HpddmOptionParseString analogue) */
int HpddmTpuOptionSet(const char *text);
double HpddmTpuOptionVal(const char *key);

/* 0-based CSR; arrays are copied */
long long HpddmTpuMatrixCSRCreate(int n, int m, int nnz, double *a,
                                  int *ia, int *ja, int sym);
void HpddmTpuMatrixCSRDestroy(long long h);
/* y = A x, column-major (n, mu) */
void HpddmTpuCSRMM(long long h, const double *x, double *y, int mu);

/* exact local factorization (RCM banded on the device) */
long long HpddmTpuSubdomainNumfact(long long h_mat);
void HpddmTpuSubdomainSolve(long long h, const double *b, double *x,
                            int mu);
void HpddmTpuSubdomainDestroy(long long h);

/* overlapping Schwarz decomposition, all S subdomains in one handle */
long long HpddmTpuSchwarzCreate(int S);
/* nbrs[nnbr]: neighbor subdomain ids; maps_flat: concatenated local
 * index lists (lengths in map_sizes), elementwise-aligned pairwise and
 * sorted by global id on both sides; d: partition of unity (length n_s)
 * or NULL on every subdomain for 1/multiplicity scaling */
int HpddmTpuSchwarzSetSubdomain(long long h, int s, long long h_mat,
                                int nnbr, int *nbrs, int *map_sizes,
                                int *maps_flat, double *d);
/* optional: local Neumann matrix enabling GenEO when
 * -hpddm_schwarz_coarse_correction is set */
int HpddmTpuSchwarzSetNeumann(long long h, int s, long long h_mat);
int HpddmTpuSchwarzBuild(long long h);
/* f/x: arrays of S per-subdomain buffers, column-major (n_s, mu);
 * returns iterations (negative if not converged) */
int HpddmTpuSolve(long long h, double **f, double **x, int S, int mu);
int HpddmTpuSchwarzComputeResidual(long long h, double **x, double **f,
                                   double *out, int S, int mu);
void HpddmTpuSchwarzDestroy(long long h);

#ifdef __cplusplus
}
#endif
#endif /* HPDDM_TPU_C_H */
