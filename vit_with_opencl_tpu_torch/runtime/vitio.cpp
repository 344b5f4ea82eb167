// vitio — native host-runtime IO for the PyTorch/CUDA ViT port.
//
// The port's own copy of the JAX package's runtime/vitio.cpp, with the same
// C ABI. Native-code counterpart of the reference's C host layer: the
// packed-image and per-tensor-weight binary readers (reference:
// Network.c:26-218), the POSIX directory scan the reference needed a Windows
// shim for (dirent.c:6-45 — here it's just <dirent.h>), and the result-file
// writer/comparator pair (Main.c:59-72, comparator.c:26-92). Exposed as a C
// ABI for ctypes (runtime/native.py); the Python io layer uses it when built
// and falls back to the pure-NumPy implementation otherwise.
//
// Design differences from the reference (deliberate):
//   * one contiguous buffer per batch instead of per-image struct copies;
//   * errors return codes/nullptr with a message channel instead of
//     perror+exit (kernelHandler.h:6-10 CHECK_ERROR exits the process);
//   * the weight loader reports missing indices instead of leaving NULLs;
//   * 6-decimal rounding (Network.c:208-211 semantics: roundf half away
//     from zero on the float32 product) is a flag, on by default.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <string>
#include <vector>

#include <dirent.h>
#include <sys/stat.h>

extern "C" {

static thread_local std::string g_error;

const char* vitio_last_error() { return g_error.c_str(); }

static void set_error(const std::string& msg) { g_error = msg; }

// ---------------------------------------------------------------------------
// Images: header of 4 little-endian int32 (n, c, h, w) + n*c*h*w float32.
// ---------------------------------------------------------------------------

float* vitio_load_images(const char* path, int32_t header_out[4]) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    set_error(std::string("cannot open ") + path);
    return nullptr;
  }
  int32_t hdr[4];
  if (std::fread(hdr, sizeof(int32_t), 4, f) != 4) {
    set_error(std::string("truncated header in ") + path);
    std::fclose(f);
    return nullptr;
  }
  for (int i = 0; i < 4; ++i) {
    if (hdr[i] <= 0) {
      set_error("bad header value");
      std::fclose(f);
      return nullptr;
    }
    header_out[i] = hdr[i];
  }
  // Overflow-checked element count (four int32 can overflow size_t); also
  // reject anything past 1T elements — no real input is that large.
  const size_t kMaxElements = (size_t)1 << 40;
  size_t total = 1;
  for (int i = 0; i < 4; ++i) {
    if (total > kMaxElements / (size_t)hdr[i]) {
      set_error("header dimensions overflow");
      std::fclose(f);
      return nullptr;
    }
    total *= (size_t)hdr[i];
  }
  float* data = (float*)std::malloc(total * sizeof(float));
  if (!data) {
    set_error("allocation failed");
    std::fclose(f);
    return nullptr;
  }
  if (std::fread(data, sizeof(float), total, f) != total) {
    set_error(std::string("short read in ") + path);
    std::free(data);
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);
  return data;
}

void vitio_free(void* p) { std::free(p); }

// ---------------------------------------------------------------------------
// Weights: directory of Weight_<idx>_<name>.bin raw-float32 files.
// ---------------------------------------------------------------------------

// Round every value to 6 decimals the way the reference does at load time:
// roundf(x * 1e6f) / 1e6f — float32 multiply, round half away from zero.
static void round_6dp(float* data, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    data[i] = std::roundf(data[i] * 1000000.0f) / 1000000.0f;
  }
}

// Parse "<idx>" from "Weight_<idx>_<rest>.bin"; -1 if not a weight file.
static int parse_weight_index(const char* name) {
  if (std::strncmp(name, "Weight_", 7) != 0) return -1;
  const char* p = name + 7;
  if (*p < '0' || *p > '9') return -1;
  char* end = nullptr;
  long idx = std::strtol(p, &end, 10);
  if (end == p || *end != '_') return -1;
  size_t len = std::strlen(name);
  if (len < 4 || std::strcmp(name + len - 4, ".bin") != 0) return -1;
  return (int)idx;
}

// Loads all weight tensors in [0, count). On success returns 0 and fills
// data_out[i] (malloc'd float32 arrays, caller frees via vitio_free) and
// size_out[i] (element counts; 0 where missing). Returns the number of
// missing indices (>0) if strict and some are absent, -1 on I/O error.
int vitio_load_weights(const char* directory, int count, int round_to_6dp,
                       int strict, float** data_out, int64_t* size_out) {
  for (int i = 0; i < count; ++i) {
    data_out[i] = nullptr;
    size_out[i] = 0;
  }
  DIR* dir = opendir(directory);
  if (!dir) {
    set_error(std::string("cannot open directory ") + directory);
    return -1;
  }
  // Collect and sort names first so duplicate-index resolution ("last wins")
  // matches the NumPy loader's sorted(os.listdir()) order, not readdir()'s
  // filesystem order.
  std::vector<std::string> names;
  struct dirent* entry;
  while ((entry = readdir(dir)) != nullptr) {
    if (parse_weight_index(entry->d_name) >= 0) names.push_back(entry->d_name);
  }
  closedir(dir);
  std::sort(names.begin(), names.end());
  for (const std::string& name : names) {
    int idx = parse_weight_index(name.c_str());
    if (idx < 0 || idx >= count) continue;
    std::string path = std::string(directory) + "/" + name;
    FILE* fp = std::fopen(path.c_str(), "rb");
    if (!fp) {
      set_error("cannot open " + path);
      return -1;
    }
    struct stat st;
    if (stat(path.c_str(), &st) != 0 || st.st_size % sizeof(float) != 0) {
      set_error("bad size for " + path);
      std::fclose(fp);
      return -1;
    }
    size_t n = (size_t)st.st_size / sizeof(float);
    float* buf = (float*)std::malloc(st.st_size);
    if (!buf || std::fread(buf, sizeof(float), n, fp) != n) {
      set_error("short read in " + path);
      std::free(buf);
      std::fclose(fp);
      return -1;
    }
    std::fclose(fp);
    if (round_to_6dp) round_6dp(buf, n);
    if (data_out[idx]) std::free(data_out[idx]);  // last duplicate wins
    data_out[idx] = buf;
    size_out[idx] = (int64_t)n;
  }
  if (strict) {
    int missing = 0;
    for (int i = 0; i < count; ++i)
      if (!data_out[i]) ++missing;
    if (missing) {
      set_error("missing weight indices");
      return missing;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Result file emission + comparator.
// ---------------------------------------------------------------------------

// Writes "[i] label: L / prob: P" lines from a [n, num_classes] probability
// matrix, with a correct per-image argmax (the reference's argmax carries
// its index across images — Main.c:59-69 — which is a latent bug we fix).
int vitio_write_results(const char* path, const float* probs, int n,
                        int num_classes) {
  FILE* f = std::fopen(path, "w");
  if (!f) {
    set_error(std::string("cannot open ") + path);
    return -1;
  }
  for (int i = 0; i < n; ++i) {
    const float* row = probs + (size_t)i * num_classes;
    int best = 0;
    for (int j = 1; j < num_classes; ++j)
      if (row[j] > row[best]) best = j;
    std::fprintf(f, "[%d] label: %d / prob: %.6f\n", i, best, row[best]);
  }
  std::fclose(f);
  return 0;
}

// Line-by-line parity: exact label match, probability within tol.
// Returns the error count (0 = pass), -1 if a file cannot be opened.
// image_count < 0 means "compare every line of the answer file".
int vitio_compare_results(const char* result_path, const char* answer_path,
                          int image_count, float tol) {
  FILE* fr = std::fopen(result_path, "r");
  if (!fr) {
    set_error(std::string("cannot open ") + result_path);
    return -1;
  }
  FILE* fa = std::fopen(answer_path, "r");
  if (!fa) {
    set_error(std::string("cannot open ") + answer_path);
    std::fclose(fr);
    return -1;
  }
  char lr[1024], la[1024];
  int errors = 0, line = 0;
  while (image_count < 0 || line < image_count) {
    char* gr = std::fgets(lr, sizeof lr, fr);
    char* ga = std::fgets(la, sizeof la, fa);
    if (!ga) {
      if (image_count >= 0 && line < image_count) ++errors;
      break;  // answer exhausted
    }
    if (!gr) {
      ++errors;  // result shorter than answer
      break;
    }
    int label_r, label_a;
    float prob_r, prob_a;
    if (std::sscanf(lr, "[%*d] label: %d / prob: %f", &label_r, &prob_r) != 2 ||
        std::sscanf(la, "[%*d] label: %d / prob: %f", &label_a, &prob_a) != 2) {
      ++errors;
      ++line;
      continue;
    }
    if (label_r != label_a) ++errors;
    if (std::fabs(prob_r - prob_a) > tol) ++errors;
    ++line;
  }
  std::fclose(fr);
  std::fclose(fa);
  return errors;
}

}  // extern "C"
