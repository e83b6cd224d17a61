// PyTorch bindings of the hand-written CUDA kernels of this directory:
// flow_level (flow_level.cu), component_extents (component_extents.cu), nms
// (nms.cu), sor_solve (sor_solve.cu), warp_bilinear (warp.cu),
// label_components (label_components.cu) and irls_coefficients (irls.cu),
// and the routes K2's and K6's propagations take (cluster_strips.cuh).
// Built together as one extension by utils/cuda.py::build; the Python
// wrappers (ops/flow_level.py, ops/component_extents.py, detect/nms.py,
// ops/sor_solve.py, ops/warp.py, ops/label_components.py, ops/irls.py) call
// these on CUDA tensors only. Only this file includes PyTorch's headers: the .cu files
// have plain C++ launchers, which keeps their compilation short.

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>
#include <cuda_runtime.h>
#include <torch/extension.h>

#include <cstdint>
#include <string>
#include <tuple>
#include <vector>

cudaError_t flow_level_launch(const float* im1, const float* im2, float* u,
                              float* v, float* mx, float* fields,
                              float* warped, float* red, int B, int H, int W,
                              int C, int n_outer, int n_sor, float alpha,
                              float omega, float one_m_omega, float eps,
                              int r_cap, float outer_tol, bool tiled,
                              cudaStream_t st);
int flow_level_num_fields();
void flow_level_resident_plan(int H, int W, int out[2]);
int flow_level_active_clusters(int H, int W);
void sor_tiles_schedule(int out[3]);
int component_extents_route(int H, int W);
int64_t component_extents_scratch_bytes(int B, int H, int W);
cudaError_t component_extents_launch(const uint8_t* masks, int32_t* mnr,
                                     int32_t* mxr, int32_t* mnc, int32_t* mxc,
                                     void* scratch, int B, int H, int W,
                                     int max_iters, cudaStream_t st);
int64_t nms_smem_bytes(int64_t N);
int64_t nms_scratch_bytes(int64_t B, int64_t N, int64_t max_out,
                          int64_t max_smem);
cudaError_t nms_launch(const float* boxes, const float* scores, int32_t* idx,
                       bool* mask, void* scratch, int B, int N, int max_out,
                       float thr, cudaStream_t st);
cudaError_t sor_solve_launch(const float* const* fields, float* scratch,
                             float* du, float* dv, int B, int H, int W,
                             int n_sor, float alpha, float omega,
                             float one_m_omega, cudaStream_t st);
cudaError_t warp_bilinear_launch(const float* im, const float* u,
                                 const float* v, float* out, float* out_right,
                                 int B, int H, int W, int C, cudaStream_t st);
int label_components_route(int H, int W);
int64_t label_components_scratch_bytes(int B, int H, int W);
cudaError_t label_components_launch(const uint8_t* masks, int32_t* out,
                                    void* scratch, int B, int H, int W,
                                    int max_iters, cudaStream_t st);
cudaError_t irls_coefficients_launch(const float* im1, const float* warped,
                                     const float* warped_grad, const float* u,
                                     const float* v, const float* du,
                                     const float* dv, float* out, int B, int H,
                                     int W, int C, float eps, cudaStream_t st);

namespace {

constexpr int64_t kMaxSmem = 232448;  // dynamic shared memory of one H100 block
constexpr int64_t kMaxExtentsSide = 65534;  // component_extents.cu kMaxSide

void check_launch(cudaError_t err, const char* what) {
  TORCH_CHECK(err == cudaSuccess, what, ": ", cudaGetErrorString(err));
}

// The SOR tiles' schedule the caller expects (ops/sor_solve.py::SCHEDULE)
// must be the one compiled into csrc/sor_tiles.cuh.
void check_schedule(const std::vector<int64_t>& schedule, const char* what) {
  int compiled[3];
  sor_tiles_schedule(compiled);
  TORCH_CHECK(schedule.size() == 3 && schedule[0] == compiled[0] &&
                  schedule[1] == compiled[1] && schedule[2] == compiled[2],
              what, ": SOR schedule ", c10::IntArrayRef(schedule),
              " differs from the compiled (", compiled[0], ", ", compiled[1],
              ", ", compiled[2], ")");
}

// The device-memory route's buffers of cluster_strips.cuh (none when the
// masks take the cluster route).
torch::Tensor strip_scratch(int64_t bytes, const torch::Tensor& like) {
  return bytes ? torch::empty({bytes}, like.options().dtype(torch::kUInt8))
               : torch::Tensor();
}

void* scratch_ptr(const torch::Tensor& t) {
  return t.defined() ? t.data_ptr() : nullptr;
}

torch::Tensor cuda_f32(const torch::Tensor& t, const char* name) {
  TORCH_CHECK(t.is_cuda() && t.scalar_type() == torch::kFloat32, name,
              " must be a float32 CUDA tensor");
  return t.contiguous();
}

// The resident SOR's plan the caller expects for H x W
// (ops/flow_level.py::resident_plan) must be the one compiled into
// csrc/sor_resident.cuh.
void check_resident_plan(const std::vector<int64_t>& plan, int64_t H,
                         int64_t W) {
  int compiled[2];
  flow_level_resident_plan((int)H, (int)W, compiled);
  TORCH_CHECK(plan.size() == 2 && plan[0] == compiled[0] &&
                  plan[1] == compiled[1],
              "flow_level: resident plan ", c10::IntArrayRef(plan), " for ",
              H, "x", W, " differs from the compiled (", compiled[0], ", ",
              compiled[1], ")");
}

std::tuple<torch::Tensor, torch::Tensor, torch::Tensor> run_flow_level(
    const torch::Tensor& im1_in, const torch::Tensor& im2_in,
    const torch::Tensor& u, const torch::Tensor& v, int64_t n_outer,
    int64_t n_sor, double alpha, double omega, double eps, int64_t r_cap,
    double outer_tol, bool tiled) {
  const auto im1 = cuda_f32(im1_in, "im1"), im2 = cuda_f32(im2_in, "im2");
  TORCH_CHECK(im1.dim() == 4 && im2.sizes() == im1.sizes(),
              "im1, im2 must be (B, H, W, C) alike");
  const int64_t B = im1.size(0), H = im1.size(1), W = im1.size(2),
                C = im1.size(3);
  TORCH_CHECK(u.sizes() == v.sizes() && u.dim() == 3 && u.size(0) == B &&
                  u.size(1) == H && u.size(2) == W,
              "u, v must be (B, H, W)");
  TORCH_CHECK(B * H * W * C < (int64_t{1} << 31), "B*H*W*C must be < 2**31");
  TORCH_CHECK(n_sor >= 0, "flow_level: n_sor must be >= 0");
  const c10::cuda::CUDAGuard guard(im1.device());
  auto u_out = cuda_f32(u, "u").clone();
  auto v_out = cuda_f32(v, "v").clone();
  const auto f32 = im1.options();
  auto mx = torch::zeros({B}, f32);
  auto fields = torch::empty({flow_level_num_fields(), B, H, W}, f32);
  auto warped = torch::empty_like(im1);
  auto red = torch::zeros({2 * n_outer + 1, B}, f32);
  check_launch(
      flow_level_launch(
          im1.data_ptr<float>(), im2.data_ptr<float>(), u_out.data_ptr<float>(),
          v_out.data_ptr<float>(), mx.data_ptr<float>(),
          fields.data_ptr<float>(), warped.data_ptr<float>(),
          red.data_ptr<float>(), B, H, W, C, n_outer, n_sor, (float)alpha,
          (float)omega, (float)(1.0 - omega), (float)eps, r_cap,
          (float)outer_tol, tiled, at::cuda::getCurrentCUDAStream()),
      "flow_level");
  return {u_out, v_out, mx};
}

// (u, v, mx): see ops/flow_level.py::flow_level.
std::tuple<torch::Tensor, torch::Tensor, torch::Tensor> flow_level(
    const torch::Tensor& im1, const torch::Tensor& im2, const torch::Tensor& u,
    const torch::Tensor& v, int64_t n_outer, int64_t n_sor, double alpha,
    double omega, double eps, int64_t r_cap, double outer_tol,
    const std::vector<int64_t>& schedule,
    const std::vector<int64_t>& resident_plan) {
  check_schedule(schedule, "flow_level");
  TORCH_CHECK(im1.dim() == 4, "im1, im2 must be (B, H, W, C) alike");
  check_resident_plan(resident_plan, im1.size(1), im1.size(2));
  return run_flow_level(im1, im2, u, v, n_outer, n_sor, alpha, omega, eps,
                        r_cap, outer_tol, false);
}

// The same level with the SOR tiles' schedule at every shape: the resident
// SOR's yardstick on the card (chip_smoke.py); no path of the port calls it.
std::tuple<torch::Tensor, torch::Tensor, torch::Tensor> flow_level_tiled(
    const torch::Tensor& im1, const torch::Tensor& im2, const torch::Tensor& u,
    const torch::Tensor& v, int64_t n_outer, int64_t n_sor, double alpha,
    double omega, double eps, int64_t r_cap, double outer_tol,
    const std::vector<int64_t>& schedule) {
  check_schedule(schedule, "flow_level_tiled");
  return run_flow_level(im1, im2, u, v, n_outer, n_sor, alpha, omega, eps,
                        r_cap, outer_tol, true);
}

std::vector<int64_t> flow_level_resident_plan_of(int64_t H, int64_t W) {
  int plan[2];
  flow_level_resident_plan((int)H, (int)W, plan);
  return {plan[0], plan[1]};
}

// (min_row, max_row, min_col, max_col): see
// ops/component_extents.py::component_extents.
std::vector<torch::Tensor> component_extents(const torch::Tensor& masks,
                                             int64_t max_iters) {
  TORCH_CHECK(masks.is_cuda() && masks.dim() == 3,
              "masks must be a (B, H, W) CUDA tensor");
  const int64_t B = masks.size(0), H = masks.size(1), W = masks.size(2);
  TORCH_CHECK(H <= kMaxExtentsSide && W <= kMaxExtentsSide, "component_extents: ",
              H, "x", W, " masks exceed the 16-bit fields (H, W <= ",
              kMaxExtentsSide, ")");
  TORCH_CHECK(B * H * W < (int64_t{1} << 31), "B*H*W must be < 2**31");
  const c10::cuda::CUDAGuard guard(masks.device());
  const auto m = masks.ne(0).to(torch::kUInt8).contiguous();
  std::vector<torch::Tensor> outs;
  for (int f = 0; f < 4; ++f)
    outs.push_back(torch::empty({B, H, W}, m.options().dtype(torch::kInt32)));
  auto scratch = strip_scratch(component_extents_scratch_bytes(B, H, W), m);
  check_launch(component_extents_launch(
                   m.data_ptr<uint8_t>(), outs[0].data_ptr<int32_t>(),
                   outs[1].data_ptr<int32_t>(), outs[2].data_ptr<int32_t>(),
                   outs[3].data_ptr<int32_t>(), scratch_ptr(scratch), B, H, W,
                   max_iters, at::cuda::getCurrentCUDAStream()),
               "component_extents");
  return outs;
}

// (idx, mask): see detect/nms.py::nms.
std::vector<torch::Tensor> nms(const torch::Tensor& boxes_in,
                               const torch::Tensor& scores_in,
                               int64_t max_out, double thr) {
  const auto boxes = cuda_f32(boxes_in, "boxes");
  const auto scores = cuda_f32(scores_in, "scores");
  TORCH_CHECK(boxes.dim() == 3 && boxes.size(2) == 4,
              "boxes must be (B, N, 4)");
  const int64_t B = boxes.size(0), N = boxes.size(1);
  TORCH_CHECK(scores.dim() == 2 && scores.size(0) == B && scores.size(1) == N,
              "scores must be (B, N) = (", B, ", ", N, ")");
  TORCH_CHECK(B > 0 && N > 0 && max_out > 0, "nms: empty input or output");
  TORCH_CHECK(N < (int64_t{1} << 28), "nms: N must be < 2**28");
  const c10::cuda::CUDAGuard guard(boxes.device());
  auto idx = torch::empty({B, max_out}, boxes.options().dtype(torch::kInt32));
  auto mask = torch::empty({B, max_out}, boxes.options().dtype(torch::kBool));
  // The shared-memory route while nms_smem_bytes(N) <= kMaxSmem (N <= 8192),
  // else the device-memory route with its scratch.
  const int64_t scratch_bytes = nms_scratch_bytes(B, N, max_out, kMaxSmem);
  torch::Tensor scratch;
  if (scratch_bytes > 0)
    scratch = torch::empty({scratch_bytes}, boxes.options().dtype(torch::kUInt8));
  check_launch(nms_launch(boxes.data_ptr<float>(), scores.data_ptr<float>(),
                          idx.data_ptr<int32_t>(), mask.data_ptr<bool>(),
                          scratch_bytes > 0 ? scratch.data_ptr() : nullptr, B,
                          N, max_out, (float)thr,
                          at::cuda::getCurrentCUDAStream()),
               "nms");
  return {idx, mask};
}

// (du, dv): see ops/sor_solve.py::sor_solve.
std::vector<torch::Tensor> sor_solve(
    const torch::Tensor& a11, const torch::Tensor& a12,
    const torch::Tensor& a22, const torch::Tensor& b1, const torch::Tensor& b2,
    const torch::Tensor& wu, const torch::Tensor& wd, const torch::Tensor& wl,
    const torch::Tensor& wr, const torch::Tensor& u, const torch::Tensor& v,
    const torch::Tensor& du0, const torch::Tensor& dv0, int64_t n_sor,
    double alpha, double omega, const std::vector<int64_t>& schedule) {
  check_schedule(schedule, "sor_solve");
  static const char* names[13] = {"a11", "a12", "a22", "b1",  "b2",
                                  "wu",  "wd",  "wl",  "wr",  "u",
                                  "v",   "du0", "dv0"};
  const torch::Tensor* in[13] = {&a11, &a12, &a22, &b1, &b2, &wu, &wd,
                                 &wl,  &wr,  &u,   &v,  &du0, &dv0};
  std::vector<torch::Tensor> fields;
  for (int f = 0; f < 13; ++f) {
    fields.push_back(cuda_f32(*in[f], names[f]));
    TORCH_CHECK(fields[f].dim() == 3 && fields[f].sizes() == fields[0].sizes(),
                names[f], " must be (B, H, W) like a11");
  }
  TORCH_CHECK(n_sor >= 0, "n_sor must be >= 0");
  const int64_t B = a11.size(0), H = a11.size(1), W = a11.size(2);
  TORCH_CHECK(B * H * W < (int64_t{1} << 31), "B*H*W must be < 2**31");
  const c10::cuda::CUDAGuard guard(a11.device());
  const float* ptrs[13];
  for (int f = 0; f < 13; ++f) ptrs[f] = fields[f].data_ptr<float>();
  auto scratch = torch::empty({6, B, H, W}, fields[0].options());
  auto du = torch::empty({B, H, W}, fields[0].options());
  auto dv = torch::empty({B, H, W}, fields[0].options());
  check_launch(sor_solve_launch(ptrs, scratch.data_ptr<float>(),
                                du.data_ptr<float>(), dv.data_ptr<float>(), B,
                                H, W, n_sor, (float)alpha, (float)omega,
                                (float)(1.0 - omega),
                                at::cuda::getCurrentCUDAStream()),
               "sor_solve");
  return {du, dv};
}

// [warped] or, with both_orders, [warped, warped_right]: see
// ops/warp.py::warp_bilinear.
std::vector<torch::Tensor> warp_bilinear(const torch::Tensor& im_in,
                                         const torch::Tensor& u_in,
                                         const torch::Tensor& v_in,
                                         bool both_orders) {
  const auto im = cuda_f32(im_in, "im");
  const auto u = cuda_f32(u_in, "u"), v = cuda_f32(v_in, "v");
  TORCH_CHECK(im.dim() == 4, "im must be (B, H, W, C)");
  const int64_t B = im.size(0), H = im.size(1), W = im.size(2),
                C = im.size(3);
  TORCH_CHECK(u.dim() == 3 && u.sizes() == v.sizes() && u.size(0) == B &&
                  u.size(1) == H && u.size(2) == W,
              "u, v must be (B, H, W)");
  TORCH_CHECK(B * H * W * C < (int64_t{1} << 31), "B*H*W*C must be < 2**31");
  const c10::cuda::CUDAGuard guard(im.device());
  std::vector<torch::Tensor> out{torch::empty_like(im)};
  if (both_orders) out.push_back(torch::empty_like(im));
  check_launch(warp_bilinear_launch(
                   im.data_ptr<float>(), u.data_ptr<float>(),
                   v.data_ptr<float>(), out[0].data_ptr<float>(),
                   both_orders ? out[1].data_ptr<float>() : nullptr, B, H, W,
                   C, at::cuda::getCurrentCUDAStream()),
               "warp_bilinear");
  return out;
}

// See ops/label_components.py::label_components.
torch::Tensor label_components(const torch::Tensor& masks, int64_t max_iters) {
  TORCH_CHECK(masks.is_cuda() && masks.dim() == 3,
              "masks must be a (B, H, W) CUDA tensor");
  const int64_t B = masks.size(0), H = masks.size(1), W = masks.size(2);
  TORCH_CHECK(B * H * W < (int64_t{1} << 31), "B*H*W must be < 2**31");
  const c10::cuda::CUDAGuard guard(masks.device());
  const auto m = masks.ne(0).to(torch::kUInt8).contiguous();
  auto out = torch::empty({B, H, W}, m.options().dtype(torch::kInt32));
  auto scratch = strip_scratch(label_components_scratch_bytes(B, H, W), m);
  check_launch(label_components_launch(
                   m.data_ptr<uint8_t>(), out.data_ptr<int32_t>(),
                   scratch_ptr(scratch), B, H, W, max_iters,
                   at::cuda::getCurrentCUDAStream()),
               "label_components");
  return out;
}

// (a11, a12, a22, b1, b2, wu, wd, wl, wr) as one 9 x (B, H, W) tensor: see
// ops/irls.py::irls_coefficients.
torch::Tensor irls_coefficients(
    const torch::Tensor& im1_in, const torch::Tensor& warped_in,
    const torch::Tensor& warped_grad_in, const torch::Tensor& u_in,
    const torch::Tensor& v_in, const torch::Tensor& du_in,
    const torch::Tensor& dv_in, double eps) {
  const auto im1 = cuda_f32(im1_in, "im1");
  const auto warped = cuda_f32(warped_in, "warped");
  const auto warped_grad = cuda_f32(warped_grad_in, "warped_grad");
  TORCH_CHECK(im1.dim() == 4 && warped.sizes() == im1.sizes() &&
                  warped_grad.sizes() == im1.sizes(),
              "im1, warped, warped_grad must be (B, H, W, C) alike");
  const int64_t B = im1.size(0), H = im1.size(1), W = im1.size(2),
                C = im1.size(3);
  TORCH_CHECK(B > 0 && B <= 65535 && H > 0 && W > 0 && C > 0,
              "irls_coefficients: need 1 <= B <= 65535 and H, W, C >= 1, got (",
              B, ", ", H, ", ", W, ", ", C, ")");
  TORCH_CHECK(9 * B * H * W < (int64_t{1} << 31) &&
                  B * H * W * C < (int64_t{1} << 31),
              "irls_coefficients: 9*B*H*W and B*H*W*C must be < 2**31");
  static const char* names[4] = {"u", "v", "du", "dv"};
  const torch::Tensor* in[4] = {&u_in, &v_in, &du_in, &dv_in};
  std::vector<torch::Tensor> flow;
  for (int f = 0; f < 4; ++f) {
    flow.push_back(cuda_f32(*in[f], names[f]));
    TORCH_CHECK(flow[f].dim() == 3 && flow[f].size(0) == B &&
                    flow[f].size(1) == H && flow[f].size(2) == W,
                names[f], " must be (B, H, W) = (", B, ", ", H, ", ", W, ")");
  }
  const c10::cuda::CUDAGuard guard(im1.device());
  auto out = torch::empty({9, B, H, W}, im1.options());
  check_launch(irls_coefficients_launch(
                   im1.data_ptr<float>(), warped.data_ptr<float>(),
                   warped_grad.data_ptr<float>(), flow[0].data_ptr<float>(),
                   flow[1].data_ptr<float>(), flow[2].data_ptr<float>(),
                   flow[3].data_ptr<float>(), out.data_ptr<float>(), B, H, W,
                   C, (float)eps, at::cuda::getCurrentCUDAStream()),
               "irls_coefficients");
  return out;
}

// The route each propagation takes for H x W masks (cluster_strips.cuh):
// "narrow" or "wide" words on the thread-block cluster, or "device" memory.
std::string component_extents_route_of(int64_t H, int64_t W) {
  static const char* names[3] = {"narrow", "wide", "device"};
  return names[component_extents_route(H, W)];
}

// "shared" or "device" memory: where K3 keeps a frame of N boxes' keys.
std::string nms_route_of(int64_t N) {
  return nms_smem_bytes(N) <= kMaxSmem ? "shared" : "device";
}

std::string label_components_route_of(int64_t H, int64_t W) {
  return label_components_route(H, W) == 0 ? "cluster" : "device";
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("flow_level", &flow_level);
  m.def("flow_level_tiled", &flow_level_tiled);
  m.def("flow_level_resident_plan", &flow_level_resident_plan_of);
  m.def("flow_level_active_clusters", &flow_level_active_clusters);
  m.def("component_extents", &component_extents);
  m.def("nms", &nms);
  m.def("sor_solve", &sor_solve);
  m.def("warp_bilinear", &warp_bilinear);
  m.def("label_components", &label_components);
  m.def("irls_coefficients", &irls_coefficients);
  m.def("component_extents_route", &component_extents_route_of);
  m.def("label_components_route", &label_components_route_of);
  m.def("nms_route", &nms_route_of);
}
