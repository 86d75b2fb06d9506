// C inference API for models saved by paddle_tpu_torch (or paddle_tpu):
// the port of csrc/paddle_tpu_capi.h.
//
// Parity: the reference's paddle/fluid/inference/capi/paddle_c_api.h —
// AnalysisPredictor behind a C ABI for C/Go deployment.  Here the
// predictor wraps the same Program/Executor runtime the Python front end
// uses (paddle_tpu_torch.io.load_inference_model + Executor.run, the
// kernels on the card), hosted in an embedded CPython when called from a
// plain C process, or the already running interpreter when loaded into a
// Python process.
//
// The one change to the JAX package's signatures: PD_NewPredictor takes
// the device to run on ("cuda", "cuda:1", "cpu"; NULL means "cuda"), as
// the Python entry points do; there is no silent fallback to the CPU.
//
// Build (shared library):
//   g++ -O2 -shared -fPIC paddle_tpu_torch/csrc/predictor_capi.cpp \
//       $(python3-config --includes) $(python3-config --embed --ldflags) \
//       -o libpaddle_tpu_torch_capi.so
//
// All functions return 0 on success, nonzero on failure, and are
// GIL-correct from any thread.

#ifndef PADDLE_TPU_TORCH_CAPI_H_
#define PADDLE_TPU_TORCH_CAPI_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct PD_Predictor PD_Predictor;

// Load an inference model saved by fluid.io.save_inference_model from
// `model_dir`, to run on `device` (NULL: "cuda").  Returns NULL on failure
// (call PD_LastError for details).
PD_Predictor* PD_NewPredictor(const char* model_dir, const char* device);

void PD_DeletePredictor(PD_Predictor* p);

// Number of feed / fetch slots and their names (valid until the
// predictor is deleted).
int PD_FeedCount(PD_Predictor* p);
int PD_FetchCount(PD_Predictor* p);
const char* PD_FeedName(PD_Predictor* p, int i);

// Bind float32 input data for feed slot `name`: `shape` has `ndim`
// dims; data is copied.
int PD_SetInput(PD_Predictor* p, const char* name, const float* data,
                const int64_t* shape, int ndim);

// Run the program on the bound inputs.
int PD_Run(PD_Predictor* p);

// Fetch output slot i as float32.  *data points at predictor-owned
// memory valid until the next PD_Run/PD_Delete; shape/ndim likewise.
int PD_GetOutput(PD_Predictor* p, int i, const float** data,
                 const int64_t** shape, int* ndim);

// Last error message (thread-shared, valid until next failing call).
const char* PD_LastError(void);

#ifdef __cplusplus
}
#endif

#endif  // PADDLE_TPU_TORCH_CAPI_H_
