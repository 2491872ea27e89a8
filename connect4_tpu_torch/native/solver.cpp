// Exact Connect4 solver (weak solve: win/draw/loss for the side to move).
//
// The port's own copy of connect4_tpu/native/solver.cpp. The reference
// framework depended on the UCI "connect-4" dataset for its 8-ply evaluation
// labels (oinkoink/scripts/generate_8ply.py) and on lookups into that table
// for the 7-ply policy labels (generate_7ply.py). This solver regenerates both from
// first principles: alpha-beta proof search over {-1, 0, +1} outcomes with
// a lock-free shared transposition table (8-byte atomic entries,
// mirror-canonical keys), threat-aware pruning and centre-first move
// ordering, parallelised over positions with std::thread. Standard Connect4
// bitboard layout: one uint64 per side, 7 bits per column
// (bit col*7 + row, row 0 = bottom, row 6 is a sentinel).
//
// Exposed as a C ABI for Python ctypes (see solver.py).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int WIDTH = 7;
constexpr int HEIGHT = 6;
constexpr int H1 = HEIGHT + 1;  // column stride (sentinel row on top)

constexpr uint64_t column_mask(int col) {
  return ((UINT64_C(1) << HEIGHT) - 1) << (col * H1);
}

constexpr uint64_t bottom_row() {
  uint64_t b = 0;
  for (int c = 0; c < WIDTH; ++c) b |= UINT64_C(1) << (c * H1);
  return b;
}

constexpr uint64_t BOTTOM = bottom_row();
constexpr uint64_t BOARD_MASK = BOTTOM * ((UINT64_C(1) << HEIGHT) - 1);

inline uint64_t top_cell(int col) {
  return UINT64_C(1) << ((HEIGHT - 1) + col * H1);
}

inline bool playable(uint64_t mask, int col) {
  return (mask & top_cell(col)) == 0;
}

inline uint64_t play_cell(uint64_t mask, int col) {
  // lowest empty cell of the column: (mask + bottom_bit) & column
  return (mask + (UINT64_C(1) << (col * H1))) & column_mask(col);
}

inline uint64_t mirror_bits(uint64_t b) {
  uint64_t r = 0;
  for (int c = 0; c < WIDTH; ++c) {
    r |= ((b >> (c * H1)) & UINT64_C(0x7F)) << ((WIDTH - 1 - c) * H1);
  }
  return r;
}

inline bool has_won(uint64_t pos) {
  uint64_t m = pos & (pos >> H1);  // horizontal
  if (m & (m >> (2 * H1))) return true;
  m = pos & (pos >> HEIGHT);  // diagonal '\'
  if (m & (m >> (2 * HEIGHT))) return true;
  m = pos & (pos >> (H1 + 1));  // diagonal '/'
  if (m & (m >> (2 * (H1 + 1)))) return true;
  m = pos & (pos >> 1);  // vertical
  return (m & (m >> 2)) != 0;
}

// All cells that would complete a four for `pos` (may include occupied or
// sentinel cells; callers mask).
uint64_t winning_cells(uint64_t pos) {
  uint64_t r = (pos << 1) & (pos << 2) & (pos << 3);  // vertical

  auto line = [&](int shift) {
    uint64_t p = (pos << shift) & (pos << (2 * shift));
    uint64_t acc = p & (pos << (3 * shift));  // XXX.
    acc |= p & (pos >> shift);                // XX.X
    p = (pos >> shift) & (pos >> (2 * shift));
    acc |= p & (pos << shift);   // X.XX
    acc |= p & (pos >> (3 * shift));  // .XXX
    return acc;
  };
  r |= line(H1);      // horizontal
  r |= line(HEIGHT);  // diagonal '\'
  r |= line(H1 + 1);  // diagonal '/'
  return r & BOARD_MASK;
}

// -- lock-free transposition table -----------------------------------------
//
// Entry packs (key:50 | lower+1:2 | upper+1:2 | stones:6 | occupied:1) into
// one atomic uint64, storing BOTH bounds of the {-1,0,1} outcome — a narrow
// window search that proves "not a win" and later one that proves "not a
// loss" together pin the draw without a third search. The position code
// current+mask+BOTTOM fits in 50 bits, so the key is exact. Races are
// benign: entries are self-consistent single words; concurrent merges may
// lose one update but never corrupt.
//
// The table is organised as 2-way buckets with a depth-preferred slot and an
// always-replace slot. The dataset builders run tens of thousands of deep
// searches that share the same shallow middle-game skeleton; pure
// always-replace lets the leaf churn of each search evict those shared
// entries (measured: a warm table gave ~no speedup on the next positions).
// The depth-preferred slot keeps the entry with the FEWEST stones (largest
// subtree), preserving the skeleton across searches.

struct TT {
  std::vector<std::atomic<uint64_t>> table;
  uint64_t bucket_mask;  // index of a 2-slot bucket

  explicit TT(size_t size_pow2)
      : table(size_pow2 < 2 ? 2 : size_pow2),
        bucket_mask((size_pow2 < 2 ? 2 : size_pow2) / 2 - 1) {}

  static constexpr uint64_t KEY_MASK = (UINT64_C(1) << 50) - 1;

  static uint64_t pack(uint64_t key, int lower, int upper, int stones) {
    return (key & KEY_MASK) | (static_cast<uint64_t>(lower + 1) << 50) |
           (static_cast<uint64_t>(upper + 1) << 52) |
           (static_cast<uint64_t>(stones) << 54) |
           (UINT64_C(1) << 60);  // occupancy bit
  }
  static bool occupied(uint64_t e) { return (e >> 60) & 1; }
  static bool matches(uint64_t e, uint64_t key) {
    return occupied(e) && (e & KEY_MASK) == (key & KEY_MASK);
  }
  static int entry_stones(uint64_t e) { return static_cast<int>((e >> 54) & 63); }

  // Merge new bounds with any existing entry for the same key.
  void put(uint64_t key, int lower, int upper, int stones) {
    size_t base = (key & bucket_mask) * 2;
    std::atomic<uint64_t>& deep = table[base];      // depth-preferred slot
    std::atomic<uint64_t>& fresh = table[base + 1];  // always-replace slot
    uint64_t d = deep.load(std::memory_order_relaxed);
    uint64_t f = fresh.load(std::memory_order_relaxed);
    if (matches(d, key)) {
      int ol = static_cast<int>((d >> 50) & 3) - 1;
      int ou = static_cast<int>((d >> 52) & 3) - 1;
      if (ol > lower) lower = ol;
      if (ou < upper) upper = ou;
      deep.store(pack(key, lower, upper, stones), std::memory_order_relaxed);
      return;
    }
    if (matches(f, key)) {
      int ol = static_cast<int>((f >> 50) & 3) - 1;
      int ou = static_cast<int>((f >> 52) & 3) - 1;
      if (ol > lower) lower = ol;
      if (ou < upper) upper = ou;
      f = pack(key, lower, upper, stones);
      // promote into the deep slot when shallower than its occupant
      if (!occupied(d) || stones <= entry_stones(d)) {
        deep.store(f, std::memory_order_relaxed);
        fresh.store(d, std::memory_order_relaxed);
      } else {
        fresh.store(f, std::memory_order_relaxed);
      }
      return;
    }
    uint64_t e = pack(key, lower, upper, stones);
    if (!occupied(d) || stones <= entry_stones(d)) {
      deep.store(e, std::memory_order_relaxed);
      fresh.store(d, std::memory_order_relaxed);  // demote, don't drop
    } else {
      fresh.store(e, std::memory_order_relaxed);
    }
  }

  bool get(uint64_t key, int* lower, int* upper) const {
    size_t base = (key & bucket_mask) * 2;
    uint64_t e = table[base].load(std::memory_order_relaxed);
    if (!matches(e, key)) {
      e = table[base + 1].load(std::memory_order_relaxed);
      if (!matches(e, key)) return false;
    }
    *lower = static_cast<int>((e >> 50) & 3) - 1;
    *upper = static_cast<int>((e >> 52) & 3) - 1;
    return true;
  }
};

constexpr int ABORTED = -128;  // sentinel: node budget exhausted

struct Worker {
  TT* tt;
  uint64_t nodes = 0;
  uint64_t budget = ~UINT64_C(0);  // max nodes before aborting the search

  // canonical (mirror-min) position code
  static uint64_t code(uint64_t current, uint64_t mask) {
    uint64_t k1 = current + mask + BOTTOM;
    uint64_t k2 = mirror_bits(current) + mirror_bits(mask) + BOTTOM;
    return k1 < k2 ? k1 : k2;
  }

  // Outcome for the side to move on (current, mask): 1 win, 0 draw, -1 loss,
  // or ABORTED once the node budget is exhausted (TT bounds stay valid).
  int solve(uint64_t current, uint64_t mask, int alpha, int beta) {
    if (++nodes > budget) return ABORTED;
    uint64_t opponent = mask ^ current;

    uint64_t empties = BOARD_MASK & ~mask;
    uint64_t my_wins = winning_cells(current) & empties;
    uint64_t playable_cells = 0;
    for (int c = 0; c < WIDTH; ++c) {
      if (playable(mask, c)) playable_cells |= play_cell(mask, c);
    }
    if (my_wins & playable_cells) return 1;  // immediate win

    if (!empties) return 0;  // board full: draw

    // Dead-side bounds: a side whose every line of four is already blocked
    // can never win, capping its best outcome at a draw. Quiet drawish
    // positions collapse long before the board fills (the weak-solve
    // analogue of score-range pruning in strong solvers).
    bool i_can_ever_win = has_won(current | empties);
    bool opp_can_ever_win = has_won(opponent | empties);
    if (!i_can_ever_win && !opp_can_ever_win) return 0;
    if (!i_can_ever_win) {
      if (beta > 0) beta = 0;  // my best possible outcome is a draw
      if (alpha >= beta) return beta;
    }
    if (!opp_can_ever_win) {
      if (alpha < 0) alpha = 0;  // opponent can no longer beat me
      if (beta <= alpha) return alpha;
    }

    uint64_t opp_wins = winning_cells(opponent) & empties;
    uint64_t forced = opp_wins & playable_cells;
    uint64_t candidates;
    if (forced) {
      if (forced & (forced - 1)) return -1;  // two immediate threats
      candidates = forced;                   // must block
    } else {
      candidates = playable_cells;
    }
    candidates &= ~(opp_wins >> 1);  // never open a win for the opponent
    if (!candidates) return -1;

    uint64_t key = code(current, mask);
    int t_lower, t_upper;
    if (tt->get(key, &t_lower, &t_upper)) {
      if (t_lower == t_upper) return t_lower;
      if (t_lower >= beta) return t_lower;
      if (t_upper <= alpha) return t_upper;
      if (t_lower > alpha) alpha = t_lower;
      if (t_upper < beta) beta = t_upper;
      if (alpha >= beta) return alpha;
    }
    const int alpha0 = alpha;

    // move ordering: centre-out, then by threats created (stable sort),
    // with enhanced transposition cutoffs — children already bounded in
    // the TT can cut this node without a recursive call, and known child
    // upper bounds (good for us after negation) are searched first.
    static constexpr int kOrder[WIDTH] = {3, 2, 4, 1, 5, 0, 6};
    int scores[WIDTH];
    int cols[WIDTH];
    int n = 0;
    int etc_best = -2;  // best score proven by child TT probes alone
    for (int i = 0; i < WIDTH; ++i) {
      int c = kOrder[i];
      if (!playable(mask, c)) continue;
      uint64_t cell = play_cell(mask, c);
      if (!(candidates & cell)) continue;
      uint64_t next = current | cell;
      int score = __builtin_popcountll(winning_cells(next) & empties);
      int c_lower, c_upper;
      if (tt->get(code(opponent, mask | cell), &c_lower, &c_upper)) {
        if (-c_upper >= beta) return -c_upper;  // ETC: proven cutoff
        if (-c_lower <= alpha && c_lower == c_upper) {
          if (-c_lower > etc_best) etc_best = -c_lower;
          continue;  // exactly known and can't raise alpha: skip the child
        }
        if (-c_upper > alpha) score += 64;  // promising: search first
      }
      scores[n] = score;
      cols[n] = c;
      ++n;
    }
    if (n == 0) return etc_best <= -2 ? -1 : etc_best;
    for (int i = 1; i < n; ++i) {
      int s = scores[i], c = cols[i], j = i;
      while (j > 0 && scores[j - 1] < s) {
        scores[j] = scores[j - 1];
        cols[j] = cols[j - 1];
        --j;
      }
      scores[j] = s;
      cols[j] = c;
    }

    int best = etc_best > -1 ? etc_best : -1;
    for (int i = 0; i < n; ++i) {
      uint64_t cell = play_cell(mask, cols[i]);
      int score = -solve(opponent, mask | cell, -beta, -alpha);
      if (score == -ABORTED || score == ABORTED) return ABORTED;
      if (score > best) best = score;
      if (best > alpha) alpha = best;
      if (alpha >= beta) break;
    }

    int stones = __builtin_popcountll(mask);
    if (best <= alpha0) {
      tt->put(key, -1, best, stones);  // upper bound
    } else if (best >= beta) {
      tt->put(key, best, 1, stones);  // lower bound
    } else {
      tt->put(key, best, best, stones);  // exact
    }
    return best;
  }
};

int solve_entry(TT* tt, uint64_t* nodes, uint64_t to_move_bits,
                uint64_t other_bits, uint64_t budget) {
  if (has_won(to_move_bits)) return 1;
  if (has_won(other_bits)) return -1;
  uint64_t mask = to_move_bits | other_bits;
  if ((mask & BOARD_MASK) == BOARD_MASK) return 0;
  Worker w{tt};
  if (budget) w.budget = budget;
  // Null-window dichotomy over the {-1,0,1} outcome (the weak-solve
  // analogue of iterative null-window search): prove "win vs <= draw"
  // with window (0,1), then "loss vs draw" with window (-1,0). Each
  // narrow window cuts far earlier than one (-1,1) search, and the
  // two-bound TT carries the first search's bounds into the second.
  int r = w.solve(to_move_bits, mask, 0, 1);
  if (r != ABORTED && r < 1) {
    // fail-soft: r <= 0 proves value <= 0; pin down draw vs loss.
    int r2 = w.solve(to_move_bits, mask, -1, 0);
    r = (r2 == ABORTED) ? ABORTED : (r2 >= 0 ? 0 : -1);
  }
  if (nodes) *nodes += w.nodes;
  return r;
}

struct SolverHandle {
  TT tt;
  uint64_t nodes = 0;
  explicit SolverHandle(size_t n) : tt(n) {}
};

}  // namespace

extern "C" {

void* solver_create(uint64_t tt_size_pow2) {
  return new SolverHandle(static_cast<size_t>(tt_size_pow2));
}

void solver_destroy(void* s) { delete static_cast<SolverHandle*>(s); }

uint64_t solver_nodes(void* s) { return static_cast<SolverHandle*>(s)->nodes; }

// Outcome for the side to move: 1 win, 0 draw, -1 loss.
int solver_solve(void* sv, uint64_t to_move_bits, uint64_t other_bits) {
  SolverHandle* s = static_cast<SolverHandle*>(sv);
  return solve_entry(&s->tt, &s->nodes, to_move_bits, other_bits, 0);
}

// Batch solve across `n_threads` workers sharing the table. `budget` = max
// nodes per position (0 = unlimited); positions exceeding it get -128 in
// `out` and can be re-solved later (accumulated TT bounds remain valid).
void solver_solve_batch(void* sv, const uint64_t* to_move_bits,
                        const uint64_t* other_bits, int64_t n, int8_t* out,
                        int n_threads, uint64_t budget) {
  SolverHandle* s = static_cast<SolverHandle*>(sv);
  if (n_threads <= 1) {
    for (int64_t i = 0; i < n; ++i) {
      out[i] = static_cast<int8_t>(solve_entry(&s->tt, &s->nodes,
                                               to_move_bits[i], other_bits[i],
                                               budget));
    }
    return;
  }
  std::atomic<int64_t> next{0};
  std::atomic<uint64_t> total_nodes{0};
  auto work = [&]() {
    uint64_t local_nodes = 0;
    for (;;) {
      int64_t i = next.fetch_add(1, std::memory_order_relaxed);
      if (i >= n) break;
      out[i] = static_cast<int8_t>(solve_entry(
          &s->tt, &local_nodes, to_move_bits[i], other_bits[i], budget));
    }
    total_nodes.fetch_add(local_nodes, std::memory_order_relaxed);
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(work);
  for (auto& th : threads) th.join();
  s->nodes += total_nodes.load();
}

}  // extern "C"
