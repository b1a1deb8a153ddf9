// A leaky relu, forward and backward, as C++ host kernels registered with
// torch's operator registration (torch/library.h): the example extension
// that utils.cpp_extension.load builds in tests/test_torch_custom_op.py
// and in chip_smoke.py (the counterpart of tests/test_cpp_extension.py's
// XLA FFI source).  The ops register for the CPU dispatch key only.
#include <torch/library.h>
#include <ATen/core/Tensor.h>
#include <ATen/ops/empty_like.h>

static at::Tensor leaky_relu_fwd(const at::Tensor& x, double alpha) {
  TORCH_CHECK(x.scalar_type() == at::kFloat, "leaky_fwd: float32 only");
  at::Tensor xc = x.contiguous();
  at::Tensor y = at::empty_like(xc);
  const float* xi = xc.data_ptr<float>();
  float* yo = y.data_ptr<float>();
  const float a = static_cast<float>(alpha);
  for (int64_t i = 0; i < xc.numel(); ++i)
    yo[i] = xi[i] > 0.0f ? xi[i] : a * xi[i];
  return y;
}

static at::Tensor leaky_relu_bwd(const at::Tensor& x, const at::Tensor& ct,
                                 double alpha) {
  at::Tensor xc = x.contiguous(), gc = ct.contiguous();
  at::Tensor dx = at::empty_like(xc);
  const float* xi = xc.data_ptr<float>();
  const float* g = gc.data_ptr<float>();
  float* out = dx.data_ptr<float>();
  const float a = static_cast<float>(alpha);
  for (int64_t i = 0; i < xc.numel(); ++i)
    out[i] = xi[i] > 0.0f ? g[i] : a * g[i];
  return dx;
}

TORCH_LIBRARY(leaky_ext, m) {
  m.def("LeakyReluFwd(Tensor x, float alpha) -> Tensor");
  m.def("LeakyReluBwd(Tensor x, Tensor ct, float alpha) -> Tensor");
}

TORCH_LIBRARY_IMPL(leaky_ext, CPU, m) {
  m.impl("LeakyReluFwd", &leaky_relu_fwd);
  m.impl("LeakyReluBwd", &leaky_relu_bwd);
}
