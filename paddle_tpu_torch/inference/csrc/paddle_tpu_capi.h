/* C ABI for the paddle_tpu_torch inference Predictor.
 *
 * Reference analog: paddle_inference_c (paddle/fluid/inference/capi),
 * the surface go/paddle binds.  Implemented by predictor_capi.cpp, which
 * embeds CPython and drives paddle_tpu_torch.inference.Predictor; link
 * against libpaddle_tpu_torch_capi.so and the Python runtime.  The
 * embedded interpreter must be able to import paddle_tpu_torch and torch
 * (PYTHONPATH).
 *
 * Device: the predictor serves on the current CUDA device.  Set the
 * environment variable PADDLE_TPU_TORCH_CAPI_DEVICE=cpu before
 * PT_NewPredictor to serve on the CPU instead ("gpu", or unset, asks
 * for the card).  With no CUDA device and no request for the CPU,
 * PT_NewPredictor prints the placement error and returns NULL: it never
 * serves on the CPU unasked.
 *
 * Threading: every entry point acquires the GIL internally, so calls
 * from any host thread are individually safe, but outputs are stashed
 * per predictor, so a Run -> GetOutput SEQUENCE must be serialized per
 * predictor by the caller (concurrent Runs on one predictor would
 * interleave each other's outputs).  Distinct predictors are
 * independent.  All arrays are float32 (an int64 input such as token
 * ids goes in as float32, exact below 2^24, and the predictor casts it
 * to the saved program's dtype); shapes are int64.
 */
#ifndef PADDLE_TPU_TORCH_CAPI_H_
#define PADDLE_TPU_TORCH_CAPI_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct PT_Predictor PT_Predictor;

typedef struct PT_Output {
  float* data;
  int64_t* shape;
  int32_t ndim;
  int64_t numel;
} PT_Output;

/* Load a jit.save'd model (path prefix, no extension).  NULL on
 * failure (error text on stderr). */
PT_Predictor* PT_NewPredictor(const char* model_path_prefix);

/* Run with n_inputs float32 buffers; shapes[i] has ndims[i] dims.
 * Returns the number of outputs, < 0 on error. */
int32_t PT_PredictorRun(PT_Predictor* p, const float* const* inputs,
                        const int64_t* const* shapes,
                        const int32_t* ndims, int32_t n_inputs);

/* Copy output idx of the last successful run into *out (free with
 * PT_FreeOutput).  0 on success. */
int32_t PT_GetOutput(PT_Predictor* p, int32_t idx, PT_Output* out);

void PT_FreeOutput(PT_Output* out);

void PT_DeletePredictor(PT_Predictor* p);

#ifdef __cplusplus
}  /* extern "C" */
#endif

#endif  /* PADDLE_TPU_TORCH_CAPI_H_ */
