// The card's kernels, copies and sets between start and stop, from CUPTI's
// activity records, summed by name in C: a count and nanoseconds a name.
// A trace of 10^6 records then costs milliseconds after the traced call,
// where torch.profiler's stop and a walk of its events cost some 20 us a
// record.  CUPTI hands full buffers to `completed` on its own thread, so
// most records are summed while the call runs.
//
// Nothing links libcupti: start() opens the libcupti the process holds (or
// the one at the path it is given), so this collector and torch.profiler
// share one CUPTI.  Built by chip_smoke.py with nvcc (host code only).
#include <cupti.h>
#include <cxxabi.h>
#include <dlfcn.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>

namespace {

using RegisterFn = CUptiResult (*)(CUpti_BuffersCallbackRequestFunc,
                                   CUpti_BuffersCallbackCompleteFunc);
using KindFn = CUptiResult (*)(CUpti_ActivityKind);
using NextFn = CUptiResult (*)(uint8_t *, size_t, CUpti_Activity **);
using FlushFn = CUptiResult (*)(uint32_t);

RegisterFn register_fn = nullptr;  // set once the symbols are found
KindFn enable_fn = nullptr, disable_fn = nullptr;
NextFn next_fn = nullptr;
FlushFn flush_fn = nullptr;

constexpr int kSlots = 1 << 14;
constexpr size_t kBufferBytes = 8 << 20;
const char kMemcpy[] = "[memcpy]";
const char kMemset[] = "[memset]";
const CUpti_ActivityKind kKinds[] = {CUPTI_ACTIVITY_KIND_CONCURRENT_KERNEL,
                                     CUPTI_ACTIVITY_KIND_MEMCPY,
                                     CUPTI_ACTIVITY_KIND_MEMSET};

struct Entry {
  const char *name;   // CUPTI's; one string for every record of a kernel
  uint64_t count, ns;
};
Entry table[kSlots];  // open addressing on the name's address
Entry dense[kSlots];  // the used slots, packed by stop()
uint64_t n_lost = 0;     // records past a full table
std::mutex mu;

void add(const char *name, uint64_t ns) {
  size_t h = (reinterpret_cast<uintptr_t>(name) >> 4) % kSlots;
  for (int probe = 0; probe < kSlots; ++probe, h = (h + 1) % kSlots) {
    Entry &e = table[h];
    if (e.name != name && e.name != nullptr) continue;
    if (e.name == nullptr) e.name = name;
    ++e.count;
    e.ns += ns;
    return;
  }
  ++n_lost;
}

void CUPTIAPI requested(uint8_t **buffer, size_t *size, size_t *max_records) {
  *buffer = static_cast<uint8_t *>(aligned_alloc(8, kBufferBytes));
  *size = *buffer == nullptr ? 0 : kBufferBytes;
  *max_records = 0;
}

void CUPTIAPI completed(CUcontext, uint32_t, uint8_t *buffer, size_t,
                        size_t valid) {
  std::lock_guard<std::mutex> lock(mu);
  CUpti_Activity *rec = nullptr;
  while (next_fn(buffer, valid, &rec) == CUPTI_SUCCESS) {
    // every version of these records keeps start, end (and a kernel's
    // name) where version 4 (kernels) and 1 (copies, sets) put them
    if (rec->kind == CUPTI_ACTIVITY_KIND_KERNEL ||
        rec->kind == CUPTI_ACTIVITY_KIND_CONCURRENT_KERNEL) {
      auto *k = reinterpret_cast<CUpti_ActivityKernel4 *>(rec);
      add(k->name, k->end - k->start);
    } else if (rec->kind == CUPTI_ACTIVITY_KIND_MEMCPY) {
      auto *m = reinterpret_cast<CUpti_ActivityMemcpy *>(rec);
      add(kMemcpy, m->end - m->start);
    } else if (rec->kind == CUPTI_ACTIVITY_KIND_MEMSET) {
      auto *m = reinterpret_cast<CUpti_ActivityMemset *>(rec);
      add(kMemset, m->end - m->start);
    }
  }
  free(buffer);
}

}  // namespace

extern "C" {

// Starts a trace.  0 on success, else the step that failed times 1000
// (1 open libcupti, 2 find its symbols, 3 register, 4 enable) plus CUPTI's
// error code.  The buffer callbacks are registered at every start: a
// torch.profiler run in between registers its own.
int repro_trace_start(const char *libcupti) {
  if (register_fn == nullptr) {
    void *lib = dlopen(libcupti, RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen(libcupti, RTLD_NOW);
    if (lib == nullptr) return 1000;
    auto sym = [lib](const char *name) { return dlsym(lib, name); };
    next_fn = reinterpret_cast<NextFn>(sym("cuptiActivityGetNextRecord"));
    flush_fn = reinterpret_cast<FlushFn>(sym("cuptiActivityFlushAll"));
    enable_fn = reinterpret_cast<KindFn>(sym("cuptiActivityEnable"));
    disable_fn = reinterpret_cast<KindFn>(sym("cuptiActivityDisable"));
    register_fn = reinterpret_cast<RegisterFn>(
        sym("cuptiActivityRegisterCallbacks"));
    if (!next_fn || !flush_fn || !enable_fn || !disable_fn || !register_fn) {
      register_fn = nullptr;
      return 2000;
    }
  }
  CUptiResult r = register_fn(requested, completed);
  if (r != CUPTI_SUCCESS) return 3000 + r;
  {
    std::lock_guard<std::mutex> lock(mu);
    memset(table, 0, sizeof(table));
    n_lost = 0;
  }
  for (CUpti_ActivityKind kind : kKinds) {
    r = enable_fn(kind);
    if (r != CUPTI_SUCCESS) return 4000 + r;
  }
  return 0;
}

// Delivers every record, stops the trace and returns the number of names
// (-1 if a flush failed).
int repro_trace_stop(void) {
  if (flush_fn(CUPTI_ACTIVITY_FLAG_FLUSH_FORCED) != CUPTI_SUCCESS) return -1;
  for (CUpti_ActivityKind kind : kKinds) disable_fn(kind);
  if (flush_fn(CUPTI_ACTIVITY_FLAG_FLUSH_FORCED) != CUPTI_SUCCESS) return -1;
  std::lock_guard<std::mutex> lock(mu);
  int n = 0;
  for (int h = 0; h < kSlots; ++h)
    if (table[h].name != nullptr) dense[n++] = table[h];
  return n;
}

// Records lost to a full table.
uint64_t repro_trace_lost(void) { return n_lost; }

// Name i of the last trace, demangled into out (cap bytes), with its count
// and nanoseconds.
void repro_trace_entry(int i, char *out, size_t cap, uint64_t *count,
                       uint64_t *ns) {
  int status = 0;
  char *dem = abi::__cxa_demangle(dense[i].name, nullptr, nullptr, &status);
  strncpy(out, status == 0 && dem != nullptr ? dem : dense[i].name, cap - 1);
  out[cap - 1] = '\0';
  free(dem);
  *count = dense[i].count;
  *ns = dense[i].ns;
}

}  // extern "C"
