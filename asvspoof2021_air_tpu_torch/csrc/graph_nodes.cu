// The nodes of a CUDA graph while it is being captured: host functions only,
// for utils/profiling.Capture. Both take the capturing stream and touch the
// graph only through queries, which CUDA permits on a graph under capture;
// neither adds a node. A span notes the capture's frontier where it opens
// and closes (asv_capture_frontier, cheap at any graph size); the table at
// the capture's end (asv_capture_node_table) places each frontier in the
// graph's creation order.
//
// A kernel node's name comes from libcuda (cuGraphKernelNodeGetParams,
// then cuFuncGetName, or cuKernelGetName where the node holds a CUkernel),
// its entry points looked up at run time, demangled by abi::__cxa_demangle
// as the profiler demangles the names of the kernels it records. Where
// libcuda lacks an entry point or gives no name, the name is empty.

#include <cuda_runtime.h>
#include <cxxabi.h>
#include <dlfcn.h>

#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

// CUDA_KERNEL_NODE_PARAMS_v2 of cuda.h.
struct KernelNodeParams {
  void* func;
  unsigned int grid[3];
  unsigned int block[3];
  unsigned int shared_mem_bytes;
  void** kernel_params;
  void** extra;
  void* kern;
  void* ctx;
};

typedef int (*GetParamsFn)(cudaGraphNode_t, KernelNodeParams*);
typedef int (*GetNameFn)(const char**, void*);

struct LibCuda {
  GetParamsFn get_params = nullptr;
  GetNameFn func_name = nullptr;
  GetNameFn kernel_name = nullptr;
  LibCuda() {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib == nullptr) return;
    get_params = reinterpret_cast<GetParamsFn>(
        dlsym(lib, "cuGraphKernelNodeGetParams_v2"));
    func_name = reinterpret_cast<GetNameFn>(dlsym(lib, "cuFuncGetName"));
    kernel_name = reinterpret_cast<GetNameFn>(dlsym(lib, "cuKernelGetName"));
  }
};

const LibCuda& libcuda() {
  static LibCuda d;
  return d;
}

std::string kernel_name(cudaGraphNode_t node) {
  const LibCuda& d = libcuda();
  if (d.get_params == nullptr) return "";
  KernelNodeParams p;
  std::memset(&p, 0, sizeof(p));
  if (d.get_params(node, &p) != 0) return "";
  const char* mangled = nullptr;
  if (p.func != nullptr && d.func_name != nullptr) d.func_name(&mangled, p.func);
  if (mangled == nullptr && p.kern != nullptr && d.kernel_name != nullptr)
    d.kernel_name(&mangled, p.kern);
  if (mangled == nullptr) return "";
  int status = 0;
  char* plain = abi::__cxa_demangle(mangled, nullptr, nullptr, &status);
  std::string out = (status == 0 && plain != nullptr) ? plain : mangled;
  std::free(plain);
  return out;
}

// The graph under capture on `stream` (null where it is not capturing) and
// the nodes its next node would depend on: the last node captured on it,
// or, after a join, the last of each branch joined.
cudaError_t capture_state(cudaStream_t stream, cudaGraph_t* graph,
                          const cudaGraphNode_t** deps, size_t* n_deps) {
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  *graph = nullptr;
  *n_deps = 0;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, &id, graph,
                                             deps, nullptr, n_deps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, &id, graph,
                                             deps, n_deps);
#endif
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) {
    *graph = nullptr;
    *n_deps = 0;
  }
  return cudaSuccess;
}

cudaError_t nodes_of(cudaGraph_t graph, std::vector<cudaGraphNode_t>* out) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess) return err;
  out->resize(n);
  if (n == 0) return cudaSuccess;
  return cudaGraphGetNodes(graph, out->data(), &n);
}

struct Work {
  int kind;          // 0 kernel, 1 memset, 2 memcpy
  long long owner;   // index of the top-level node it belongs to
  std::string name;
};

// The work nodes of `graph` in the order cudaGraphGetNodes lists them, the
// nodes of a child graph in place of the child graph's node.
cudaError_t work_of(cudaGraph_t graph, long long owner, std::vector<Work>* out) {
  std::vector<cudaGraphNode_t> nodes;
  cudaError_t err = nodes_of(graph, &nodes);
  if (err != cudaSuccess) return err;
  for (size_t i = 0; i < nodes.size(); ++i) {
    const long long who = owner < 0 ? static_cast<long long>(i) : owner;
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    if (err != cudaSuccess) return err;
    if (type == cudaGraphNodeTypeKernel) {
      out->push_back({0, who, kernel_name(nodes[i])});
    } else if (type == cudaGraphNodeTypeMemset) {
      out->push_back({1, who, ""});
    } else if (type == cudaGraphNodeTypeMemcpy) {
      out->push_back({2, who, ""});
    } else if (type == cudaGraphNodeTypeGraph) {
      cudaGraph_t child = nullptr;
      err = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (err != cudaSuccess) return err;
      err = work_of(child, who, out);
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

}  // namespace

// The handles of the nodes that the next node captured on `stream` would
// depend on, at most `cap` of them into `handles`; *n receives their
// number, -1 where the stream is not capturing. A query of the stream's
// capture state: it costs the same however many nodes the graph holds.
extern "C" int asv_capture_frontier(void* stream, unsigned long long* handles,
                                    long long cap, long long* n) {
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = capture_state(static_cast<cudaStream_t>(stream), &graph,
                                  &deps, &n_deps);
  *n = -1;
  if (err != cudaSuccess || graph == nullptr) return err;
  *n = static_cast<long long>(n_deps);
  for (size_t i = 0; i < n_deps && static_cast<long long>(i) < cap; ++i)
    handles[i] = reinterpret_cast<unsigned long long>(deps[i]);
  return cudaSuccess;
}

// The nodes of the graph being captured on `stream`: the handles of its
// top-level nodes in the order cudaGraphGetNodes lists them (creation
// order) into `tops`, and its work nodes (kernels, memsets, memcpys), child
// graphs flattened: kinds[i] (0 kernel, 1 memset, 2 memcpy), owners[i] (the
// index among the top-level nodes of the node it is or lies in), and the
// kernels' names, each ended by a NUL (an empty name for every other node),
// one after another in `names`. *n_tops, *n and *names_len receive the
// counts the whole lists need; the arrays are written only when all fit
// (`tops_cap` and `cap` entries, `names_cap` bytes).
extern "C" int asv_capture_node_table(void* stream,
                                      unsigned long long* tops,
                                      long long tops_cap, int* kinds,
                                      long long* owners, long long cap,
                                      char* names, long long names_cap,
                                      long long* n_tops, long long* n,
                                      long long* names_len) {
  *n_tops = 0;
  *n = 0;
  *names_len = 0;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = capture_state(static_cast<cudaStream_t>(stream), &graph,
                                  &deps, &n_deps);
  if (err != cudaSuccess || graph == nullptr) return err;
  std::vector<cudaGraphNode_t> top;
  err = nodes_of(graph, &top);
  if (err != cudaSuccess) return err;
  std::vector<Work> work;
  err = work_of(graph, -1, &work);
  if (err != cudaSuccess) return err;
  long long bytes = 0;
  for (const Work& w : work) bytes += static_cast<long long>(w.name.size()) + 1;
  *n_tops = static_cast<long long>(top.size());
  *n = static_cast<long long>(work.size());
  *names_len = bytes;
  if (*n_tops > tops_cap || *n > cap || bytes > names_cap) return cudaSuccess;
  for (size_t i = 0; i < top.size(); ++i)
    tops[i] = reinterpret_cast<unsigned long long>(top[i]);
  char* at = names;
  for (size_t i = 0; i < work.size(); ++i) {
    kinds[i] = work[i].kind;
    owners[i] = work[i].owner;
    std::memcpy(at, work[i].name.c_str(), work[i].name.size() + 1);
    at += work[i].name.size() + 1;
  }
  return cudaSuccess;
}
