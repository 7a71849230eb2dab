/* Minimal single-process MPI shim for building the reference's example
 * drivers in environments without MPI development headers.  This engine
 * has no MPI runtime — parallelism is jax.sharding over the device mesh —
 * so reference drivers' MPI calls reduce to single-rank no-ops (rank 0,
 * size 1, broadcasts and reductions are identities).  Header-only; only
 * the calls used by the reference examples are provided.  If a real MPI
 * is installed, put its include dir first on the include path. */
#ifndef EDIPACK_TPU_MPI_SHIM_H
#define EDIPACK_TPU_MPI_SHIM_H

typedef int MPI_Comm;
typedef int MPI_Datatype;
typedef int MPI_Op;

#define MPI_COMM_WORLD 0
#define MPI_COMM_SELF 1
#define MPI_INT 1
#define MPI_DOUBLE 2
#define MPI_DOUBLE_COMPLEX 3
#define MPI_C_BOOL 4
#define MPI_SUM 1
#define MPI_SUCCESS 0

#ifdef __cplusplus
#define EDTPU_MPI_INLINE inline
extern "C++" {
#else
#define EDTPU_MPI_INLINE static inline
#endif

EDTPU_MPI_INLINE int MPI_Init(int *argc, char ***argv) {
  (void)argc; (void)argv;
  return MPI_SUCCESS;
}
EDTPU_MPI_INLINE int MPI_Finalize(void) { return MPI_SUCCESS; }
EDTPU_MPI_INLINE int MPI_Comm_rank(MPI_Comm comm, int *rank) {
  (void)comm; *rank = 0;
  return MPI_SUCCESS;
}
EDTPU_MPI_INLINE int MPI_Comm_size(MPI_Comm comm, int *size) {
  (void)comm; *size = 1;
  return MPI_SUCCESS;
}
EDTPU_MPI_INLINE int MPI_Barrier(MPI_Comm comm) {
  (void)comm;
  return MPI_SUCCESS;
}
EDTPU_MPI_INLINE int MPI_Bcast(void *buf, int count, MPI_Datatype t,
                               int root, MPI_Comm comm) {
  (void)buf; (void)count; (void)t; (void)root; (void)comm;
  return MPI_SUCCESS;
}
EDTPU_MPI_INLINE int MPI_Allreduce(const void *send, void *recv, int count,
                                   MPI_Datatype t, MPI_Op op,
                                   MPI_Comm comm) {
  (void)t; (void)op; (void)comm;
  if (send != recv && send) {
    const char *s = (const char *)send;
    char *r = (char *)recv;
    long bytes = (long)count * (t == MPI_INT ? 4 : t == MPI_DOUBLE ? 8 : 16);
    for (long i = 0; i < bytes; ++i) r[i] = s[i];
  }
  return MPI_SUCCESS;
}

#ifdef __cplusplus
}
#endif
#undef EDTPU_MPI_INLINE
#endif /* EDIPACK_TPU_MPI_SHIM_H */
