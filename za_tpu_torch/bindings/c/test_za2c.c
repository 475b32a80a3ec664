/* Round trip through the port's C ABI (za2c.h):
 *
 *   test_za2c WORKDIR [ENGINE [INPUTS [PK]]]
 *
 * ENGINE: gpu (the default engine, the card), host (engine("host")) or
 * nocard (the default engine without a card: setup and prove must give
 * 100 with the CUDA error and write nothing).  Without PK: setup of
 * WORKDIR/circuit.za (written with the reference test's p*q=r circuit
 * when there is none) into WORKDIR/proving.key and verifier.json; with
 * PK, WORKDIR/verifier.json holds its verifier.  Then INPUTS (default
 * {"p":"2","q":"3","r":"6"}) are proved into WORKDIR/proof.json, the
 * proof must verify and, with its first public input changed, give 2.
 * engine("tpu") and a verifier type "xml" must give 100; without PK a
 * proof buffer too small must give 1.  Every file lies under WORKDIR,
 * so runs can go side by side.  Prints each call's seconds ("za2c
 * <call> <s>") and the stage_info of the process's GpuEngines
 * ("engines [...]"). */
#include <Python.h>

#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>
#include <unistd.h>

#include "za2c.h"

static const char* CIRCUIT =
    "template Factor() {\n"
    "  signal private input p;\n"
    "  signal private input q;\n"
    "  signal input r;\n"
    "  p * q === r;\n"
    "}\n"
    "component main = Factor();\n";

static char verifier[1 << 20];
static char proof[1 << 20];
static char err[1 << 16];
static char path[4096];
static const char* work;

static const char* in_work(const char* name) {
  snprintf(path, sizeof(path), "%s/%s", work, name);
  return path;
}

static double now(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + ts.tv_nsec * 1e-9;
}

static int fail(const char* what, int rc) {
  fprintf(stderr, "%s: rc=%d err=%s\n", what, rc, err);
  return 1;
}

static int write_file(const char* name, const char* text) {
  FILE* f = fopen(in_work(name), "w");
  if (f == NULL) return 0;
  fputs(text, f);
  return fclose(f) == 0;
}

static int read_file(const char* name, char* buf, size_t size) {
  FILE* f = fopen(in_work(name), "r");
  if (f == NULL) return 0;
  size_t n = fread(buf, 1, size - 1, f);
  buf[n] = '\0';
  fclose(f);
  return 1;
}

static int exists(const char* name) { return access(in_work(name), F_OK) == 0; }

/* the stage_info of every GpuEngine the binding built */
static void report_engines(void) {
  PyGILState_STATE gil = PyGILState_Ensure();
  PyRun_SimpleString(
      "import gc, json, warnings\n"
      "from za_tpu_torch.engine.engine import GpuEngine\n"
      "with warnings.catch_warnings():\n"
      "    warnings.simplefilter('ignore')\n"
      "    found = [o.stage_info for o in gc.get_objects()\n"
      "             if isinstance(o, GpuEngine)]\n"
      "print('engines', json.dumps(found), flush=True)\n");
  PyGILState_Release(gil);
}

/* the default engine without a card refuses; the host sets up */
static int no_card(void) {
  const char* pk = "proving.key";
  char pk_path[4096];
  snprintf(pk_path, sizeof(pk_path), "%s", in_work(pk));
  int rc = setup(in_work("circuit.za"), pk_path, "json", verifier,
                 sizeof(verifier), err, sizeof(err));
  if (rc != 100 || strstr(err, "CUDA") == NULL || exists(pk))
    return fail("setup on no card", rc);
  if ((rc = engine("host")) != 0) return fail("engine(host)", rc);
  rc = setup(in_work("circuit.za"), pk_path, "json", verifier,
             sizeof(verifier), err, sizeof(err));
  if (rc != 0) return fail("setup on the host", rc);
  if ((rc = engine("gpu")) != 0) return fail("engine(gpu)", rc);
  rc = prove(pk_path, "{\"p\":\"2\",\"q\":\"3\",\"r\":\"6\"}", proof,
             sizeof(proof), err, sizeof(err));
  if (rc != 100 || strstr(err, "CUDA") == NULL ||
      exists("proving.key.wtrace"))
    return fail("prove on no card", rc);
  printf("NO CARD REFUSED OK\n");
  return 0;
}

int main(int argc, char** argv) {
  if (argc < 2) {
    fprintf(stderr, "usage: test_za2c WORKDIR [ENGINE [INPUTS [PK]]]\n");
    return 2;
  }
  setvbuf(stdout, NULL, _IOLBF, 0);
  work = argv[1];
  const char* eng = argc > 2 ? argv[2] : "gpu";
  const char* inputs =
      argc > 3 ? argv[3] : "{\"p\":\"2\",\"q\":\"3\",\"r\":\"6\"}";
  const char* pk_arg = argc > 4 ? argv[4] : NULL;
  char pk[4096];
  snprintf(pk, sizeof(pk), "%s", pk_arg ? pk_arg : in_work("proving.key"));
  char circuit[4096];
  snprintf(circuit, sizeof(circuit), "%s", in_work("circuit.za"));
  if (pk_arg == NULL && !exists("circuit.za") &&
      !write_file("circuit.za", CIRCUIT)) {
    fprintf(stderr, "cannot write %s\n", circuit);
    return 1;
  }

  verbose(1);
  int rc;
  if (strcmp(eng, "nocard") == 0) return no_card();
  if (strcmp(eng, "gpu") != 0 && (rc = engine(eng)) != 0)
    return fail("engine", rc);
  if ((rc = engine("tpu")) != 100) return fail("engine(tpu)", rc);
  rc = setup(circuit, in_work("bad.key"), "xml", verifier, sizeof(verifier),
             err, sizeof(err));
  if (rc != 100 || exists("bad.key")) return fail("verifier type xml", rc);

  double t0 = now();
  if (pk_arg == NULL) {
    rc = setup(circuit, pk, "json", verifier, sizeof(verifier), err,
               sizeof(err));
    if (rc != 0) return fail("setup", rc);
    printf("za2c setup %.6f\n", now() - t0);
    if (!write_file("verifier.json", verifier)) return fail("verifier.json", 0);
  } else if (!read_file("verifier.json", verifier, sizeof(verifier))) {
    return fail("read verifier.json", 0);
  }

  t0 = now();
  rc = prove(pk, inputs, proof, sizeof(proof), err, sizeof(err));
  if (rc != 0) return fail("prove", rc);
  printf("za2c prove %.6f\n", now() - t0);
  if (!write_file("proof.json", proof)) return fail("proof.json", 0);
  if (pk_arg == NULL) {
    char small[16];
    rc = prove(pk, inputs, small, sizeof(small), err, sizeof(err));
    if (rc != 1) return fail("proof buffer too small", rc);
  }

  t0 = now();
  rc = verify(verifier, proof, err, sizeof(err));
  if (rc != 0) return fail("verify", rc);
  printf("za2c verify %.6f\n", now() - t0);

  /* the first public input, changed: the proof must not verify */
  char* pos = strstr(proof, "\"public_inputs\":[\"");
  if (pos == NULL) return fail("no public input to change", 0);
  pos += strlen("\"public_inputs\":[\"");
  *pos = *pos == '9' ? '8' : (char)(*pos + 1);
  rc = verify(verifier, proof, err, sizeof(err));
  if (rc != 2) return fail("tampered proof not rejected", rc);
  printf("tampered proof rejected ok\n");
  report_engines();
  printf("ALL C BINDING TESTS PASS\n");
  return 0;
}
