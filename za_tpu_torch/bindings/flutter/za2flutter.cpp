// Flutter/mobile binding of the port: prove-only C ABI returning
// "1:<proof>" or "0:<error>" strings (the reference binding's surface,
// bindings/flutter/za2flutter.cpp: one prove entry and a string free
// function for Dart FFI) over libza2c; the engine is libza2c's, the card
// unless engine("host") was called.
#include <cstdlib>
#include <cstring>
#include <string>

#include "../c/za2c.h"

extern "C" {

char* flutter_prove(const char* pk_path, const char* inputs) {
  std::string proof(1 << 20, '\0');
  std::string err(1 << 16, '\0');
  int rc = prove(pk_path, inputs, proof.data(), proof.size(), err.data(),
                 err.size());
  std::string out = rc == 0 ? ("1:" + std::string(proof.c_str()))
                            : ("0:" + std::string(err.c_str()));
  char* heap = static_cast<char*>(std::malloc(out.size() + 1));
  std::memcpy(heap, out.c_str(), out.size() + 1);
  return heap;
}

void za_cstr_free(char* s) { std::free(s); }

}  // extern "C"
