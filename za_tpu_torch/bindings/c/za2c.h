/* C ABI of the port's libza2c: setup / prove / verify / verbose / engine.
 *
 * Error codes: 0 = ok, 1 = buffer too small, 2 = verification failed,
 * 100 = custom error (message in error_buffer).
 * setup and prove run on the CUDA card unless engine("host") was called;
 * without a card they return 100 with the CUDA error and write nothing.
 * Set ZA_TPU_ROOT to the za-tpu checkout before the first call if
 * za_tpu_torch is not importable from the default interpreter path.
 */
#ifndef ZA2C_H
#define ZA2C_H

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

void verbose(int on);

/* "gpu" (the default: the card) or "host" (the exact host code) for the
 * setup and prove calls that follow; 100 on any other name, which
 * leaves the engine as it was. */
int engine(const char* name);

int setup(const char* circuit_path, const char* pk_path,
          const char* verifier_type, char* verifier_buffer,
          size_t verifier_buffer_size, char* error_buffer,
          size_t error_buffer_size);

int prove(const char* pk_path, const char* inputs, char* proof_buffer,
          size_t proof_buffer_size, char* error_buffer,
          size_t error_buffer_size);

int verify(const char* verifying_key, const char* proof_with_inputs,
           char* error_buffer, size_t error_buffer_size);

#ifdef __cplusplus
}
#endif

#endif /* ZA2C_H */
