/* Minimal N-API declaration stub for COMPILE-PROBING za2node.cc on CI
 * images without a node toolchain (tests/test_bindings.py). Mirrors
 * the subset of <node_api.h> the addon uses; real builds use node-gyp
 * with the genuine header (binding.gyp). Not installed anywhere. */
#ifndef ZA_CI_STUB_NODE_API_H_
#define ZA_CI_STUB_NODE_API_H_

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct napi_env__* napi_env;
typedef struct napi_value__* napi_value;
typedef struct napi_callback_info__* napi_callback_info;
typedef int napi_status;

typedef napi_value (*napi_callback)(napi_env, napi_callback_info);

typedef enum { napi_default = 0 } napi_property_attributes;

typedef struct {
  const char* utf8name;
  napi_value name;
  napi_callback method;
  napi_callback getter;
  napi_callback setter;
  napi_value value;
  napi_property_attributes attributes;
  void* data;
} napi_property_descriptor;

napi_status napi_get_value_string_utf8(napi_env, napi_value, char*, size_t,
                                       size_t*);
napi_status napi_create_string_utf8(napi_env, const char*, size_t,
                                    napi_value*);
napi_status napi_throw_error(napi_env, const char*, const char*);
napi_status napi_get_boolean(napi_env, bool, napi_value*);
napi_status napi_get_value_bool(napi_env, napi_value, bool*);
napi_status napi_get_cb_info(napi_env, napi_callback_info, size_t*,
                             napi_value*, napi_value*, void**);
napi_status napi_define_properties(napi_env, napi_value, size_t,
                                   const napi_property_descriptor*);

#define NAPI_MODULE(modname, regfunc)                                   \
  napi_value __za_stub_entry_##modname(napi_env env, napi_value v) {    \
    return regfunc(env, v);                                             \
  }

#define NAPI_AUTO_LENGTH SIZE_MAX

#ifdef __cplusplus
}
#endif
#endif  /* ZA_CI_STUB_NODE_API_H_ */
