// The compiled step's inputs read where the caller holds them
// (pipeline/bind.py). No device code: the kernels run as captured.
//
// The step's CUDA graph is captured on placeholders, a slot's static
// input buffers, whose addresses the capture wrote into the kernel
// nodes' arguments. bmfr_bind_scan walks the graph once after the
// capture and records every argument word that holds an address inside
// a placeholder (the word's offset and its distance from the
// placeholder's start), struct arguments included (kernels J and K take
// their planes inside a by-value FeatureTable, F its inputs inside
// Params). It reads each argument's size from libcuda
// (cuFuncGetParamInfo). Kernel F's TMA instance also holds tensor maps
// (__grid_constant__ Maps), opaque 128 B records: they are never
// scanned or patched, but encoded again by F's own encoder for the new
// addresses (bmfr_filtered_tail_remap). bmfr_bind_apply then points the
// recorded words at the frame's tensors and hands each changed node to
// cuGraphExecKernelNodeSetParams, which changes the launches that follow
// and none already enqueued, so two frames in flight are safe.
//
// A node outside the kernels that reaches a placeholder (a copy or a
// fill) or one whose arguments cannot be read is reported, and the
// Python side copies those inputs as before. libcuda's calls are
// found through the CUDA runtime, as F's encoder is, so the library
// links without -lcuda.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

// csrc/filtered_tail.cu
extern "C" int bmfr_filtered_tail_remap(const void* old_params,
                                        const void* new_params,
                                        size_t params_size, void* maps,
                                        size_t maps_size);

namespace {

// a libcuda call the runtime does not find (negative, so it never reads as
// a CUresult; pipeline/bind.py::_check names it)
constexpr int NO_DRIVER_CALL = -2;

template <class Fn>
Fn entry(const char* name, int version) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t e = cudaGetDriverEntryPointByVersion(
      name, &p, version, cudaEnableDefault, &found);
#else
  (void)version;
  const cudaError_t e =
      cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &found);
#endif
  return e == cudaSuccess && found == cudaDriverEntryPointSuccess
             ? reinterpret_cast<Fn>(p)
             : nullptr;
}

struct Driver {
  CUresult (*get_nodes)(CUgraph, CUgraphNode*, size_t*);
  CUresult (*node_type)(CUgraphNode, CUgraphNodeType*);
  CUresult (*kernel_params)(CUgraphNode, CUDA_KERNEL_NODE_PARAMS_v2*);
  CUresult (*set_kernel_params)(CUgraphExec, CUgraphNode,
                                const CUDA_KERNEL_NODE_PARAMS_v2*);
  CUresult (*param_info)(CUfunction, size_t, size_t*, size_t*);
  CUresult (*func_name)(const char**, CUfunction);
  CUresult (*kernel_function)(CUfunction*, CUkernel);
  CUresult (*memcpy_params)(CUgraphNode, CUDA_MEMCPY3D*);
  CUresult (*memset_params)(CUgraphNode, CUDA_MEMSET_NODE_PARAMS*);

  bool complete() const {
    return get_nodes && node_type && kernel_params && set_kernel_params &&
           param_info && func_name && kernel_function && memcpy_params &&
           memset_params;
  }
};

const Driver& driver() {
  static const Driver d = [] {
    Driver d;
    d.get_nodes = entry<decltype(d.get_nodes)>("cuGraphGetNodes", 10000);
    d.node_type = entry<decltype(d.node_type)>("cuGraphNodeGetType", 10000);
    d.kernel_params = entry<decltype(d.kernel_params)>(
        "cuGraphKernelNodeGetParams", 12000);
    d.set_kernel_params = entry<decltype(d.set_kernel_params)>(
        "cuGraphExecKernelNodeSetParams", 12000);
    d.param_info =
        entry<decltype(d.param_info)>("cuFuncGetParamInfo", 12040);
    d.func_name = entry<decltype(d.func_name)>("cuFuncGetName", 12030);
    d.kernel_function =
        entry<decltype(d.kernel_function)>("cuKernelGetFunction", 12000);
    d.memcpy_params = entry<decltype(d.memcpy_params)>(
        "cuGraphMemcpyNodeGetParams", 10000);
    d.memset_params = entry<decltype(d.memset_params)>(
        "cuGraphMemsetNodeGetParams", 10000);
    return d;
  }();
  return d;
}

// what a node is to the binder (pipeline/bind.py reads these values)
enum Kind { KERNEL = 0, COPY = 1, OPAQUE = 2 };

// an argument word that points into placeholder `range`, `delta` bytes
// past its start; `at`: its byte offset in the node's arguments
struct Site {
  size_t at;
  int range;
  uint64_t delta;
};

struct Node {
  CUgraphNode node;
  CUDA_KERNEL_NODE_PARAMS_v2 params;
  std::vector<unsigned char> args;  // the arguments as the binder sets them
  std::vector<unsigned char> set;   // ... as libcuda last took them
  std::vector<size_t> offset, size;  // each argument's place in args
  std::vector<void*> ptrs;           // kernelParams: into args
  std::vector<Site> sites;
  std::string name;
  uint64_t mask = 0;  // the placeholders it reaches
  Kind kind = KERNEL;
  int maps = -1;      // kernel F's TMA instance: its Maps argument
};

struct Binder {
  std::vector<uint64_t> lo, size, bound;  // bound: the base each points at
  std::vector<Node> nodes;                // the nodes that reach one
};

uint64_t reached(const Binder& b, uint64_t start, uint64_t end) {
  uint64_t mask = 0;
  for (size_t r = 0; r < b.lo.size(); ++r)
    if (start < b.lo[r] + b.size[r] && b.lo[r] < end) mask |= 1ull << r;
  return mask;
}

uint64_t every(const Binder& b) {
  return b.lo.size() == 64 ? ~0ull : (1ull << b.lo.size()) - 1;
}

// the bytes [start, end) a copy's or fill's end touches
void span3d(uint64_t base, size_t x, size_t y, size_t z, size_t pitch,
            size_t height, size_t width, size_t rows, size_t depth,
            uint64_t* start, uint64_t* end) {
  *start = base + x + (y + z * height) * pitch;
  *end = *start + ((depth ? depth - 1 : 0) * height +
                   (rows ? rows - 1 : 0)) * pitch + width;
}

bool device_memory(CUmemorytype t) {
  return t == CU_MEMORYTYPE_DEVICE || t == CU_MEMORYTYPE_UNIFIED;
}

// a kernel node: its arguments, each word that points into a placeholder
CUresult scan_kernel(const Driver& d, const Binder& b, Node& n) {
  CUresult r = d.kernel_params(n.node, &n.params);
  if (r != CUDA_SUCCESS) return r;
  CUfunction fn = n.params.func;
  if (fn == nullptr && n.params.kern != nullptr &&
      (r = d.kernel_function(&fn, n.params.kern)) != CUDA_SUCCESS)
    return r;
  const char* name = nullptr;
  if (fn != nullptr && d.func_name(&name, fn) == CUDA_SUCCESS && name)
    n.name = name;
  size_t off, size, total = 0;
  while (fn != nullptr && n.params.kernelParams != nullptr &&
         d.param_info(fn, n.offset.size(), &off, &size) == CUDA_SUCCESS) {
    n.offset.push_back(off);
    n.size.push_back(size);
    total = off + size > total ? off + size : total;
  }
  if (n.offset.empty()) {
    // no function to ask, arguments packed in `extra`, or none libcuda
    // describes: what it reads is not known
    n.kind = OPAQUE;
    n.mask = every(b);
    return CUDA_SUCCESS;
  }
  n.args.assign(total, 0);
  for (size_t i = 0; i < n.offset.size(); ++i) {
    std::memcpy(n.args.data() + n.offset[i], n.params.kernelParams[i],
                n.size[i]);
    n.ptrs.push_back(n.args.data() + n.offset[i]);
  }
  // kernel F's TMA instance (filtered_tail_kernel<TmaLoads, Y>(Params,
  // Maps)): its maps are re-encoded, never scanned
  if (n.name.find("filtered_tail_kernel") != std::string::npos &&
      n.name.find("TmaLoads") != std::string::npos && n.offset.size() == 2)
    n.maps = 1;
  for (size_t i = 0; i < n.offset.size(); ++i) {
    if ((int)i == n.maps) continue;
    for (size_t k = 0; k + 8 <= n.size[i]; k += 8) {
      uint64_t w;
      std::memcpy(&w, n.args.data() + n.offset[i] + k, 8);
      for (size_t rg = 0; rg < b.lo.size(); ++rg)
        if (w >= b.lo[rg] && w < b.lo[rg] + b.size[rg]) {
          n.sites.push_back(Site{n.offset[i] + k, (int)rg, w - b.lo[rg]});
          n.mask |= 1ull << rg;
        }
    }
  }
  n.set = n.args;
  return CUDA_SUCCESS;
}

// any other node: does it touch a placeholder?
CUresult scan_other(const Driver& d, const Binder& b, CUgraphNodeType type,
                    Node& n) {
  uint64_t start, end;
  CUresult r = CUDA_SUCCESS;
  n.kind = COPY;
  switch (type) {
    case CU_GRAPH_NODE_TYPE_MEMCPY: {
      CUDA_MEMCPY3D c;
      if ((r = d.memcpy_params(n.node, &c)) != CUDA_SUCCESS) return r;
      if (device_memory(c.srcMemoryType)) {
        span3d(c.srcDevice, c.srcXInBytes, c.srcY, c.srcZ, c.srcPitch,
               c.srcHeight, c.WidthInBytes, c.Height, c.Depth, &start, &end);
        n.mask |= reached(b, start, end);
      }
      if (device_memory(c.dstMemoryType)) {
        span3d(c.dstDevice, c.dstXInBytes, c.dstY, c.dstZ, c.dstPitch,
               c.dstHeight, c.WidthInBytes, c.Height, c.Depth, &start, &end);
        n.mask |= reached(b, start, end);
      }
      return CUDA_SUCCESS;
    }
    case CU_GRAPH_NODE_TYPE_MEMSET: {
      CUDA_MEMSET_NODE_PARAMS m;
      if ((r = d.memset_params(n.node, &m)) != CUDA_SUCCESS) return r;
      span3d(m.dst, 0, 0, 0, m.pitch, 0, m.width * m.elementSize, m.height,
             1, &start, &end);
      n.mask = reached(b, start, end);
      return CUDA_SUCCESS;
    }
    case CU_GRAPH_NODE_TYPE_EMPTY:
    case CU_GRAPH_NODE_TYPE_WAIT_EVENT:
    case CU_GRAPH_NODE_TYPE_EVENT_RECORD:
    case CU_GRAPH_NODE_TYPE_MEM_ALLOC:
    case CU_GRAPH_NODE_TYPE_MEM_FREE:
      return CUDA_SUCCESS;
    default:  // a host node, a child graph, ...: it may read anything
      n.kind = OPAQUE;
      n.mask = every(b);
      return CUDA_SUCCESS;
  }
}

}  // namespace

// Scan `graph` for the n placeholders [lo[r], lo[r] + size[r]) (n <= 64)
// and return a binder in *out (bmfr_bind_free frees it). 0, a CUresult,
// or NO_DRIVER_CALL.
extern "C" int bmfr_bind_scan(void* graph, int n,
                              const unsigned long long* lo,
                              const unsigned long long* size, void** out) {
  const Driver& d = driver();
  if (!d.complete()) return NO_DRIVER_CALL;
  if (n < 1 || n > 64) return (int)CUDA_ERROR_INVALID_VALUE;
  Binder* b = new Binder;
  b->lo.assign(lo, lo + n);
  b->size.assign(size, size + n);
  b->bound = b->lo;
  size_t count = 0;
  CUresult r = d.get_nodes((CUgraph)graph, nullptr, &count);
  std::vector<CUgraphNode> nodes(count);
  if (r == CUDA_SUCCESS && count)
    r = d.get_nodes((CUgraph)graph, nodes.data(), &count);
  for (size_t i = 0; r == CUDA_SUCCESS && i < count; ++i) {
    Node node;
    node.node = nodes[i];
    CUgraphNodeType type;
    if ((r = d.node_type(nodes[i], &type)) != CUDA_SUCCESS) break;
    r = type == CU_GRAPH_NODE_TYPE_KERNEL ? scan_kernel(d, *b, node)
                                          : scan_other(d, *b, type, node);
    if (r == CUDA_SUCCESS && node.mask) b->nodes.push_back(std::move(node));
  }
  if (r != CUDA_SUCCESS) {
    delete b;
    return (int)r;
  }
  // the vectors moved: point kernelParams at each node's own arguments
  for (Node& node : b->nodes)
    for (size_t i = 0; i < node.ptrs.size(); ++i)
      node.ptrs[i] = node.args.data() + node.offset[i];
  *out = b;
  return 0;
}

// the number of nodes that reach a placeholder
extern "C" int bmfr_bind_nodes(void* binder) {
  return (int)static_cast<Binder*>(binder)->nodes.size();
}

// node i: its kind (KERNEL, COPY, OPAQUE), the placeholders it reaches
// (*mask, bit r) and its function's name (a kernel's; at most cap - 1
// bytes)
extern "C" int bmfr_bind_node(void* binder, int i, char* name, int cap,
                              unsigned long long* mask) {
  const Node& n = static_cast<Binder*>(binder)->nodes.at(i);
  std::strncpy(name, n.name.c_str(), cap - 1);
  name[cap - 1] = '\0';
  *mask = n.mask;
  return n.kind;
}

// Point the placeholders' words at bases[r] (one per placeholder; the
// placeholder's own address binds it back) in `exec`, the graph's
// instance; only nodes that reach a placeholder whose base changed are
// set. 0, a CUresult, NO_DRIVER_CALL or an encoder's code
// (filtered_tail.cu).
extern "C" int bmfr_bind_apply(void* binder, void* exec,
                               const unsigned long long* bases) {
  Binder* b = static_cast<Binder*>(binder);
  const Driver& d = driver();
  uint64_t changed = 0;
  for (size_t r = 0; r < b->lo.size(); ++r)
    if (bases[r] != b->bound[r]) changed |= 1ull << r;
  if (!changed) return 0;
  // libcuda's calls and F's encoder need a current context on this
  // thread, which its first CUDA call may not have made yet
  int dev;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce == cudaSuccess) ce = cudaSetDevice(dev);
  if (ce != cudaSuccess) return (int)ce;
  for (Node& n : b->nodes) {
    if (n.kind != KERNEL || !(n.mask & changed)) continue;
    for (const Site& s : n.sites) {
      const uint64_t w = bases[s.range] + s.delta;
      std::memcpy(n.args.data() + s.at, &w, 8);
    }
    if (n.maps >= 0) {
      const int e = bmfr_filtered_tail_remap(
          n.set.data() + n.offset[0], n.args.data() + n.offset[0], n.size[0],
          n.args.data() + n.offset[n.maps], n.size[n.maps]);
      if (e != 0) return e;
    }
    CUDA_KERNEL_NODE_PARAMS_v2 p = n.params;
    p.kernelParams = n.ptrs.data();
    p.extra = nullptr;
    const CUresult r = d.set_kernel_params((CUgraphExec)exec, n.node, &p);
    if (r != CUDA_SUCCESS) return (int)r;
    n.set = n.args;
  }
  b->bound.assign(bases, bases + b->lo.size());
  return 0;
}

extern "C" int bmfr_bind_free(void* binder) {
  delete static_cast<Binder*>(binder);
  return 0;
}
