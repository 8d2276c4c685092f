# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: storebus.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0estorebus.proto\x12\x0fkarmada_tpu.bus\"-\n\x0cWatchRequest\x12\r\n\x05kinds\x18\x01 \x03(\t\x12\x0e\n\x06replay\x18\x02 \x01(\x08\"_\n\x05\x45vent\x12\x0c\n\x04type\x18\x01 \x01(\t\x12\x0c\n\x04kind\x18\x02 \x01(\t\x12\x0b\n\x03key\x18\x03 \x01(\t\x12\x18\n\x10resource_version\x18\x04 \x01(\x04\x12\x13\n\x0bobject_json\x18\x05 \x01(\t\"[\n\x0c\x41pplyRequest\x12\x0c\n\x04kind\x18\x01 \x01(\t\x12\x13\n\x0bobject_json\x18\x02 \x01(\t\x12\x13\n\x0b\x63onditional\x18\x03 \x01(\x08\x12\x13\n\x0b\x65xpected_rv\x18\x04 \x01(\x04\"J\n\rApplyResponse\x12\x18\n\x10resource_version\x18\x01 \x01(\x04\x12\r\n\x05\x65rror\x18\x02 \x01(\t\x12\x10\n\x08\x63onflict\x18\x03 \x01(\x08\"9\n\rDeleteRequest\x12\x0c\n\x04kind\x18\x01 \x01(\t\x12\x0b\n\x03key\x18\x02 \x01(\t\x12\r\n\x05\x66orce\x18\x03 \x01(\x08\"0\n\x0e\x44\x65leteResponse\x12\x0f\n\x07\x64\x65leted\x18\x01 \x01(\x08\x12\r\n\x05\x65rror\x18\x02 \x01(\t2\xe5\x01\n\x08StoreBus\x12\x42\n\x05Watch\x12\x1d.karmada_tpu.bus.WatchRequest\x1a\x16.karmada_tpu.bus.Event\"\x00\x30\x01\x12H\n\x05\x41pply\x12\x1d.karmada_tpu.bus.ApplyRequest\x1a\x1e.karmada_tpu.bus.ApplyResponse\"\x00\x12K\n\x06\x44\x65lete\x12\x1e.karmada_tpu.bus.DeleteRequest\x1a\x1f.karmada_tpu.bus.DeleteResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'storebus_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _WATCHREQUEST._serialized_start=35
  _WATCHREQUEST._serialized_end=80
  _EVENT._serialized_start=82
  _EVENT._serialized_end=177
  _APPLYREQUEST._serialized_start=179
  _APPLYREQUEST._serialized_end=270
  _APPLYRESPONSE._serialized_start=272
  _APPLYRESPONSE._serialized_end=346
  _DELETEREQUEST._serialized_start=348
  _DELETEREQUEST._serialized_end=405
  _DELETERESPONSE._serialized_start=407
  _DELETERESPONSE._serialized_end=455
  _STOREBUS._serialized_start=458
  _STOREBUS._serialized_end=687
# @@protoc_insertion_point(module_scope)
