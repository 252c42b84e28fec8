// Native Wing–Gong–Lowe linearizability search.
//
// The TPU-era answer to the reference's compute plane being a JVM with
// a 32 GB heap (knossos, jepsen/project.clj:30): histories whose model
// has an int32 kernel encoding but can't ride the TPU kernel (or when
// no accelerator is attached) are searched here instead of in pure
// Python — same algorithm as ops/wgl_host.py (Lowe's linked-list
// just-lift search with a (bitset, state) memo), GIL-free and ~100×
// the Python fallback's speed.
//
// Models mirror models/jit.py's int32 encodings exactly:
//   0 cas-register  state: int32 scalar, NIL32 = unset
//   1 register
//   2 mutex
//   3 unordered-queue  state: int32[width] slot counts; memo key is the
//     bitset alone (the multiset is a function of WHICH entries are
//     linearized), and backtracking inverts the step instead of
//     snapshotting.
//
// Build: g++ -O2 -shared -fPIC -o libwglsearch.so wgl_search.cpp
// Driven via ctypes from ops/wgl_native.py.

#include <chrono>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_set>
#include <vector>

namespace {

constexpr int32_t kNil32 = 1 << 30;  // models/jit.py NIL32

enum Verdict { kFalse = 0, kTrue = 1, kUnknown = 2 };

struct Stepper {
  int kind;
  int width;  // queue state width (scalars: 1)

  // state[0] for scalars; full vector for the queue.
  // Returns ok; mutates state in place only when ok.
  bool step(std::vector<int32_t>& state, int32_t f, int32_t v1,
            int32_t v2) const {
    switch (kind) {
      case 0: {  // cas-register: 0=read 1=write 2=cas
        if (f == 0) {
          return v1 == kNil32 || state[0] == v1;
        }
        if (f == 1) {
          state[0] = v1;
          return true;
        }
        if (f == 2 && state[0] == v1) {
          state[0] = v2;
          return true;
        }
        return false;
      }
      case 1: {  // register: 0=read 1=write
        if (f == 1) {
          state[0] = v1;
          return true;
        }
        return f == 0 && (v1 == kNil32 || state[0] == v1);
      }
      case 2: {  // mutex: 0=acquire 1=release; state 0 free / 1 held
        if (f == 0 && state[0] == 0) {
          state[0] = 1;
          return true;
        }
        if (f == 1 && state[0] == 1) {
          state[0] = 0;
          return true;
        }
        return false;
      }
      case 3: {  // unordered-queue: 0=enqueue 1=dequeue; v1 = slot
        if (v1 < 0 || v1 >= width) return false;
        if (f == 0) {
          state[v1] += 1;
          return true;
        }
        if (f == 1 && state[v1] > 0) {
          state[v1] -= 1;
          return true;
        }
        return false;
      }
      case 4: {  // fifo-queue ring buffer: [buf(width-2), head, tail]
        const int w = width - 2;
        int32_t& head = state[w];
        int32_t& tail = state[w + 1];
        if (f == 0) {  // enqueue v1 at the tail
          if (tail >= w || v1 < 0) return false;
          state[tail] = v1;
          tail += 1;
          return true;
        }
        if (f == 1 && head < tail && state[head] == v1) {
          head += 1;  // value stays in place (needed by unstep)
          return true;
        }
        return false;
      }
      default:
        return false;
    }
  }

  void unstep(std::vector<int32_t>& state, int32_t f, int32_t v1) const {
    // has_unstep kinds only: exact inverse of an APPLIED transition
    if (kind == 3) {
      if (f == 0)
        state[v1] -= 1;
      else
        state[v1] += 1;
      return;
    }
    // fifo-queue: enqueue pops the tail, dequeue restores the head —
    // buf[head-1] still holds the dequeued value (never overwritten,
    // enqueues only write at tail >= head)
    const int w = width - 2;
    if (f == 0)
      state[w + 1] -= 1;
    else
      state[w] -= 1;
  }

  bool state_in_key() const { return kind != 3; }
  bool has_unstep() const { return kind == 3 || kind == 4; }

  // Memo keys must encode the LOGICAL state: the fifo ring buffer's
  // (head, tail) offsets and dead slots are representation, not state
  // — canonicalize to [live values at 0.., count, 0] so memo behavior
  // (and hence step counts) exactly matches the host search, which
  // memoizes on the model's items tuple.
  std::vector<int32_t> canon(const std::vector<int32_t>& state) const {
    if (kind != 4) return state;
    const int w = width - 2;
    const int32_t head = state[w], tail = state[w + 1];
    std::vector<int32_t> out(width, 0);
    for (int32_t i = head; i < tail; ++i) out[i - head] = state[i];
    out[w] = tail - head;
    return out;
  }
};

std::string make_key(const std::vector<uint64_t>& bits,
                     const std::vector<int32_t>& state,
                     bool state_in_key) {
  std::string out;
  out.reserve(bits.size() * 8 + (state_in_key ? state.size() * 4 : 0));
  out.append(reinterpret_cast<const char*>(bits.data()),
             bits.size() * sizeof(uint64_t));
  if (state_in_key) {
    out.append(reinterpret_cast<const char*>(state.data()),
               state.size() * sizeof(int32_t));
  }
  return out;
}

}  // namespace

extern "C" {

// Returns total search steps. out_valid: 0 false / 1 true / 2 unknown.
// out_best receives the deepest legal prefix (entry ids); caller
// provides a buffer of n ints. out_stuck is the entry at whose return
// the search died (-1 when not applicable).
long long wgl_search(int n, const int32_t* f, const int32_t* v1,
                     const int32_t* v2, const uint8_t* crashed,
                     const int64_t* call_pos, const int64_t* ret_pos,
                     int model_kind, int32_t init_state, int state_width,
                     long long max_steps, double time_limit_s,
                     int* out_valid, int* out_stuck, int* out_best,
                     int* out_best_len, long long* out_cache_size) {
  *out_valid = kUnknown;
  *out_stuck = -1;
  *out_best_len = 0;
  *out_cache_size = 0;

  int n_completed = 0;
  for (int e = 0; e < n; ++e) n_completed += crashed[e] ? 0 : 1;
  if (n_completed == 0) {
    *out_valid = kTrue;
    return 0;
  }

  Stepper stepper{model_kind, state_width};
  std::vector<int32_t> state(state_width, 0);
  if (model_kind == 3 || model_kind == 4) {
    std::fill(state.begin(), state.end(), 0);
  } else {
    state[0] = init_state;
  }

  // Event linked list: node id = event position + 1; 0 is the head
  // sentinel (and the off-the-end target).
  const int n_nodes = 2 * n + 1;
  std::vector<int> nxt(n_nodes), prv(n_nodes), node_entry(n_nodes, 0);
  std::vector<uint8_t> node_is_call(n_nodes, 0);
  std::vector<int> call_node(n), ret_node(n);
  for (int i = 0; i < n_nodes; ++i) {
    nxt[i] = i + 1;
    prv[i] = i - 1;
  }
  nxt[n_nodes - 1] = 0;
  prv[0] = 0;
  for (int e = 0; e < n; ++e) {
    int c = static_cast<int>(call_pos[e]) + 1;
    int r = static_cast<int>(ret_pos[e]) + 1;
    call_node[e] = c;
    ret_node[e] = r;
    node_entry[c] = e;
    node_entry[r] = e;
    node_is_call[c] = 1;
  }
  constexpr int kEnd = 0;

  auto lift = [&](int e) {
    for (int nd : {call_node[e], ret_node[e]}) {
      int p = prv[nd], q = nxt[nd];
      nxt[p] = q;
      if (q != kEnd) prv[q] = p;
    }
  };
  auto unlift = [&](int e) {
    for (int nd : {ret_node[e], call_node[e]}) {
      int p = prv[nd], q = nxt[nd];
      nxt[p] = nd;
      if (q != kEnd) prv[q] = nd;
    }
  };

  const int n_words = (n + 63) / 64;
  std::vector<uint64_t> lin(n_words, 0);

  struct Frame {
    int entry;
    int32_t prev_scalar;  // scalar models' state snapshot
  };
  std::vector<Frame> stack;
  stack.reserve(n);

  std::unordered_set<std::string> cache;
  // canon() copies; only the fifo kind needs canonicalization, every
  // other kind keeps the zero-copy path
  cache.insert(stepper.kind == 4
                   ? make_key(lin, stepper.canon(state), true)
                   : make_key(lin, state, stepper.state_in_key()));

  int completed_done = 0;
  int best_depth = -1;
  std::vector<int> best_entries;
  int stuck_entry = -1;

  int node = nxt[0];
  long long steps = 0;
  // computed only when a limit is set: casting a huge sentinel double
  // into the clock's int64 rep would be UB
  const bool has_deadline = time_limit_s >= 0;
  const auto deadline =
      std::chrono::steady_clock::now() +
      std::chrono::duration_cast<std::chrono::steady_clock::duration>(
          std::chrono::duration<double>(has_deadline ? time_limit_s
                                                     : 0.0));

  while (true) {
    ++steps;
    if (max_steps >= 0 && steps > max_steps) {
      *out_valid = kUnknown;
      *out_cache_size = static_cast<long long>(cache.size());
      return steps;
    }
    if (has_deadline && (steps & 4095) == 0 &&
        std::chrono::steady_clock::now() > deadline) {
      *out_valid = kUnknown;
      *out_cache_size = static_cast<long long>(cache.size());
      return steps;
    }

    if (node != kEnd && node_is_call[node]) {
      int e = node_entry[node];
      bool advanced = false;
      int32_t prev_scalar = state[0];
      std::vector<int32_t> saved;
      if (!stepper.has_unstep() && state_width > 1) saved = state;
      bool ok = stepper.step(state, f[e], v1[e], v2[e]);
      if (ok) {
        lin[e >> 6] |= (1ull << (e & 63));
        std::string key =
            stepper.kind == 4
                ? make_key(lin, stepper.canon(state), true)
                : make_key(lin, state, stepper.state_in_key());
        if (cache.insert(std::move(key)).second) {
          stack.push_back({e, prev_scalar});
          if (!crashed[e]) ++completed_done;
          lift(e);
          if (completed_done == n_completed) {
            *out_valid = kTrue;
            *out_best_len = static_cast<int>(stack.size());
            for (size_t i = 0; i < stack.size(); ++i)
              out_best[i] = stack[i].entry;
            *out_cache_size = static_cast<long long>(cache.size());
            return steps;
          }
          node = nxt[0];
          advanced = true;
        } else {
          // seen: undo the state mutation + bit
          lin[e >> 6] &= ~(1ull << (e & 63));
          if (stepper.has_unstep())
            stepper.unstep(state, f[e], v1[e]);
          else if (state_width > 1)
            state = saved;
          else
            state[0] = prev_scalar;
        }
      }
      if (!advanced) {
        if (!ok) {
          // step refused: restore scalar (queue step only mutates on ok)
          if (!stepper.has_unstep()) state[0] = prev_scalar;
        }
        node = nxt[node];
      }
    } else {
      // Return event (or end): nothing minimal linearizes here.
      if (static_cast<int>(stack.size()) > best_depth) {
        best_depth = static_cast<int>(stack.size());
        best_entries.clear();
        for (const Frame& fr : stack) best_entries.push_back(fr.entry);
        stuck_entry = (node != kEnd) ? node_entry[node] : -1;
      }
      if (stack.empty()) {
        *out_valid = kFalse;
        *out_stuck = stuck_entry;
        *out_best_len = static_cast<int>(best_entries.size());
        for (size_t i = 0; i < best_entries.size(); ++i)
          out_best[i] = best_entries[i];
        *out_cache_size = static_cast<long long>(cache.size());
        return steps;
      }
      Frame fr = stack.back();
      stack.pop_back();
      int e = fr.entry;
      lin[e >> 6] &= ~(1ull << (e & 63));
      if (stepper.has_unstep())
        stepper.unstep(state, f[e], v1[e]);
      else
        state[0] = fr.prev_scalar;
      if (!crashed[e]) --completed_done;
      unlift(e);
      node = nxt[call_node[e]];
    }
  }
}

}  // extern "C"
