// Native wav I/O and a threaded batch loader, for nelegan_tpu_torch/data.
//
// Own copy of the reference package's reader (the port uses nothing of that
// package).  The reference feeds training through torch DataLoader worker
// *processes* (reference: dataloader.py:86-100, num_workers=8); featurization
// runs on the device here, so the host only decodes wavs and assembles
// batches: a pthread pool inside one process, exposed to Python through
// ctypes (data/wavio.py, which also keeps a scipy reader as the plain
// version the tests compare with).  Built on first use with
// `g++ -O2 -shared -fPIC` into build/nelegan_tpu_torch/.
//
// Only the formats the corpus uses are supported: RIFF/WAVE, PCM16 or
// IEEE float32, mono (multi-channel is averaged), any sample rate (the
// caller checks for 16 kHz like the reference's `assert sr==16000`).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <pthread.h>

namespace {

struct WavInfo {
  int32_t sample_rate = 0;
  int32_t n_samples = 0;   // per channel
  int16_t format = 0;      // 1 = PCM, 3 = float
  int16_t channels = 0;
  int16_t bits = 0;
  long data_offset = 0;
};

bool parse_header(FILE* f, WavInfo* info) {
  char id[4];
  uint32_t sz;
  if (fread(id, 1, 4, f) != 4 || memcmp(id, "RIFF", 4)) return false;
  if (fread(&sz, 4, 1, f) != 1) return false;
  if (fread(id, 1, 4, f) != 4 || memcmp(id, "WAVE", 4)) return false;
  uint32_t data_size = 0;
  while (fread(id, 1, 4, f) == 4 && fread(&sz, 4, 1, f) == 1) {
    if (!memcmp(id, "fmt ", 4)) {
      struct {
        int16_t fmt, ch;
        int32_t rate, byterate;
        int16_t align, bits;
      } __attribute__((packed)) fmt;
      if (sz < sizeof(fmt) || fread(&fmt, sizeof(fmt), 1, f) != 1)
        return false;
      if (sz > sizeof(fmt)) fseek(f, sz - sizeof(fmt), SEEK_CUR);
      info->format = fmt.fmt;
      info->channels = fmt.ch;
      info->sample_rate = fmt.rate;
      info->bits = fmt.bits;
    } else if (!memcmp(id, "data", 4)) {
      info->data_offset = ftell(f);
      data_size = sz;
      break;
    } else {
      fseek(f, (sz + 1) & ~1u, SEEK_CUR);
    }
  }
  if (!info->data_offset || !info->channels || !info->bits) return false;
  info->n_samples = data_size / (info->bits / 8) / info->channels;
  return true;
}

// Decode one file into out[0..max_len), return n written (or -1 on error).
int32_t decode(const char* path, float* out, int32_t max_len,
               int32_t* sample_rate) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  if (!parse_header(f, &info)) {
    fclose(f);
    return -1;
  }
  if (sample_rate) *sample_rate = info.sample_rate;
  int32_t n = info.n_samples < max_len ? info.n_samples : max_len;
  fseek(f, info.data_offset, SEEK_SET);
  const int ch = info.channels;
  if (info.format == 1 && info.bits == 16) {
    int16_t* buf = (int16_t*)malloc((size_t)n * ch * 2);
    if (fread(buf, 2, (size_t)n * ch, f) != (size_t)n * ch) n = 0;
    for (int32_t i = 0; i < n; i++) {
      float acc = 0.f;
      for (int c = 0; c < ch; c++) acc += buf[i * ch + c];
      out[i] = acc / (32768.f * ch);
    }
    free(buf);
  } else if (info.format == 3 && info.bits == 32) {
    float* buf = (float*)malloc((size_t)n * ch * 4);
    if (fread(buf, 4, (size_t)n * ch, f) != (size_t)n * ch) n = 0;
    for (int32_t i = 0; i < n; i++) {
      float acc = 0.f;
      for (int c = 0; c < ch; c++) acc += buf[i * ch + c];
      out[i] = acc / ch;
    }
    free(buf);
  } else {
    n = -1;
  }
  fclose(f);
  return n;
}

struct BatchJob {
  const char** paths;
  float* out;        // [n_files, max_len], zero-filled by caller
  int32_t* lengths;  // [n_files]
  int32_t* rates;    // [n_files]
  int32_t max_len;
  int32_t n_files;
  int32_t next;      // work index
  pthread_mutex_t mu;
};

void* worker(void* arg) {
  BatchJob* job = (BatchJob*)arg;
  for (;;) {
    pthread_mutex_lock(&job->mu);
    int32_t i = job->next++;
    pthread_mutex_unlock(&job->mu);
    if (i >= job->n_files) break;
    job->lengths[i] =
        decode(job->paths[i], job->out + (size_t)i * job->max_len,
               job->max_len, &job->rates[i]);
  }
  return nullptr;
}

}  // namespace

extern "C" {

// Single-file convenience: returns samples written, -1 on failure.
int32_t wavio_read(const char* path, float* out, int32_t max_len,
                   int32_t* sample_rate) {
  return decode(path, out, max_len, sample_rate);
}

// Returns the sample count of a file without decoding (-1 on failure).
int32_t wavio_length(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  bool ok = parse_header(f, &info);
  fclose(f);
  return ok ? info.n_samples : -1;
}

// Threaded batch decode. out must be [n_files * max_len] zero-initialised.
// lengths[i] receives the decoded sample count (or -1).
void wavio_read_batch(const char** paths, int32_t n_files, float* out,
                      int32_t max_len, int32_t* lengths, int32_t* rates,
                      int32_t n_threads) {
  BatchJob job{paths, out, lengths, rates, max_len, n_files, 0,
               PTHREAD_MUTEX_INITIALIZER};
  if (n_threads < 1) n_threads = 1;
  if (n_threads > 64) n_threads = 64;
  pthread_t tids[64];
  int created = 0;
  for (int t = 0; t < n_threads; t++) {
    if (pthread_create(&tids[created], nullptr, worker, &job) != 0) break;
    created++;  // join only threads that exist (EAGAIN under pressure)
  }
  if (created == 0) worker(&job);  // degrade to inline decode
  for (int t = 0; t < created; t++) pthread_join(tids[t], nullptr);
}

// PCM16 writer (mono), matching soundfile's PCM_16 output
// (reference: train_nele.py:198 sf.write(..., 'PCM_16')).
int32_t wavio_write_pcm16(const char* path, const float* data, int32_t n,
                          int32_t sample_rate) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  uint32_t data_bytes = (uint32_t)n * 2;
  uint32_t riff = 36 + data_bytes;
  struct {
    char riff[4] = {'R', 'I', 'F', 'F'};
    uint32_t riff_size;
    char wave[4] = {'W', 'A', 'V', 'E'};
    char fmt[4] = {'f', 'm', 't', ' '};
    uint32_t fmt_size = 16;
    int16_t format = 1, channels = 1;
    int32_t rate, byterate;
    int16_t align = 2, bits = 16;
    char data[4] = {'d', 'a', 't', 'a'};
    uint32_t data_size;
  } __attribute__((packed)) hdr;
  hdr.riff_size = riff;
  hdr.rate = sample_rate;
  hdr.byterate = sample_rate * 2;
  hdr.data_size = data_bytes;
  fwrite(&hdr, sizeof(hdr), 1, f);
  for (int32_t i = 0; i < n; i++) {
    float v = data[i];
    if (v > 1.f) v = 1.f;
    if (v < -1.f) v = -1.f;
    // round-to-nearest like libsndfile
    float scaled = v * 32768.f;
    if (scaled > 32767.f) scaled = 32767.f;
    int16_t s = (int16_t)(scaled >= 0 ? scaled + 0.5f : scaled - 0.5f);
    fwrite(&s, 2, 1, f);
  }
  fclose(f);
  return n;
}

}  // extern "C"
