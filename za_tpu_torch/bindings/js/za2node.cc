// Node.js N-API addon of the port: setupSync / proveSync / verifySync /
// verbose / engine (the reference binding's surface,
// bindings/js/za2node.cc, and engine(name): "gpu", the card, by default,
// or "host"). Thin wrapper over the port's libza2c C ABI; build libza2c
// (../c/Makefile), then node-gyp (see binding.gyp). Where there is no
// node toolchain the addon is compile-probed against ci_stub/node_api.h.

#include <node_api.h>

#include <string>
#include <vector>

#include "../c/za2c.h"

namespace {

std::string GetString(napi_env env, napi_value v) {
  size_t len = 0;
  napi_get_value_string_utf8(env, v, nullptr, 0, &len);
  std::string out(len, '\0');
  napi_get_value_string_utf8(env, v, out.data(), len + 1, &len);
  return out;
}

napi_value Throw(napi_env env, const std::string& msg) {
  napi_throw_error(env, nullptr, msg.c_str());
  return nullptr;
}

napi_value SetupSync(napi_env env, napi_callback_info info) {
  size_t argc = 3;
  napi_value args[3];
  napi_get_cb_info(env, info, &argc, args, nullptr, nullptr);
  if (argc < 3) return Throw(env, "setupSync(circuit, pk, verifierType)");
  std::string circuit = GetString(env, args[0]);
  std::string pk = GetString(env, args[1]);
  std::string vt = GetString(env, args[2]);
  std::vector<char> verifier(1 << 20), err(1 << 16);
  int rc = setup(circuit.c_str(), pk.c_str(), vt.c_str(), verifier.data(),
                 verifier.size(), err.data(), err.size());
  if (rc != 0) return Throw(env, err.data());
  napi_value result;
  napi_create_string_utf8(env, verifier.data(), NAPI_AUTO_LENGTH, &result);
  return result;
}

napi_value ProveSync(napi_env env, napi_callback_info info) {
  size_t argc = 2;
  napi_value args[2];
  napi_get_cb_info(env, info, &argc, args, nullptr, nullptr);
  if (argc < 2) return Throw(env, "proveSync(pk, inputsJson)");
  std::string pk = GetString(env, args[0]);
  std::string inputs = GetString(env, args[1]);
  std::vector<char> proof(1 << 20), err(1 << 16);
  int rc = prove(pk.c_str(), inputs.c_str(), proof.data(), proof.size(),
                 err.data(), err.size());
  if (rc != 0) return Throw(env, err.data());
  napi_value result;
  napi_create_string_utf8(env, proof.data(), NAPI_AUTO_LENGTH, &result);
  return result;
}

napi_value VerifySync(napi_env env, napi_callback_info info) {
  size_t argc = 2;
  napi_value args[2];
  napi_get_cb_info(env, info, &argc, args, nullptr, nullptr);
  if (argc < 2) return Throw(env, "verifySync(vkJson, proofJson)");
  std::string vk = GetString(env, args[0]);
  std::string proof = GetString(env, args[1]);
  std::vector<char> err(1 << 16);
  int rc = verify(vk.c_str(), proof.c_str(), err.data(), err.size());
  if (rc == 100) return Throw(env, err.data());
  napi_value result;
  napi_get_boolean(env, rc == 0, &result);
  return result;
}

napi_value VerboseFn(napi_env env, napi_callback_info info) {
  size_t argc = 1;
  napi_value args[1];
  napi_get_cb_info(env, info, &argc, args, nullptr, nullptr);
  bool on = false;
  if (argc >= 1) napi_get_value_bool(env, args[0], &on);
  verbose(on ? 1 : 0);
  return nullptr;
}

napi_value EngineFn(napi_env env, napi_callback_info info) {
  size_t argc = 1;
  napi_value args[1];
  napi_get_cb_info(env, info, &argc, args, nullptr, nullptr);
  if (argc < 1) return Throw(env, "engine(name)");
  std::string name = GetString(env, args[0]);
  if (engine(name.c_str()) != 0)
    return Throw(env, "unknown engine " + name + ": gpu or host");
  return nullptr;
}

napi_value Init(napi_env env, napi_value exports) {
  napi_property_descriptor props[] = {
      {"setupSync", nullptr, SetupSync, nullptr, nullptr, nullptr,
       napi_default, nullptr},
      {"proveSync", nullptr, ProveSync, nullptr, nullptr, nullptr,
       napi_default, nullptr},
      {"verifySync", nullptr, VerifySync, nullptr, nullptr, nullptr,
       napi_default, nullptr},
      {"verbose", nullptr, VerboseFn, nullptr, nullptr, nullptr,
       napi_default, nullptr},
      {"engine", nullptr, EngineFn, nullptr, nullptr, nullptr, napi_default,
       nullptr},
  };
  napi_define_properties(env, exports, 5, props);
  return exports;
}

}  // namespace

NAPI_MODULE(za2node, Init)
