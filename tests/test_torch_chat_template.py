"""The port's chat-template renderer (dynamo_tpu_torch.llm.chat_template)
against jinja2, through each package's OpenAIPreprocessor.render_chat.

The templates are written here in the form of the reference's default
(ChatML), Llama-3, Llama-3.1 (tools), Mistral, Qwen3 (with tool calls) and
gpt-oss (harmony-style macros) templates, plus one that exercises the rest
of the expression grammar and one whose raise_exception branch fires. Over
hypothesis messages (roles, unicode and template-like content, missing and
non-string content, content parts, extra keys) the two renderings must be
the same string, or both must fail: the reference with jinja2's error, the
port with its TemplateError. Every statement, loop attribute, global,
builtin filter and test, Markup rule and scoping rule is also rendered on
its own through `ChatTemplate` and `jinja2.Environment().from_string`, with
the same outcome. A template outside the grammar is refused when the
preprocessor is built: chat answers 400 and completions still serve.
"""

import copy

import jinja2
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu.llm.model_card import ModelDeploymentCard as RefCard
from dynamo_tpu.llm.preprocessor import DEFAULT_CHAT_TEMPLATE as REF_DEFAULT
from dynamo_tpu.llm.preprocessor import OpenAIPreprocessor as RefPreprocessor
from dynamo_tpu.llm.preprocessor import RequestError as RefRequestError
from dynamo_tpu_torch.llm.chat_template import (
    ChatTemplate,
    TemplateError,
    TemplateSyntaxError,
)
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.llm.validate import RequestError

CHATML = ("{% for message in messages %}{{'<|im_start|>' + message['role'] + "
          "'\\n' + message['content'] + '<|im_end|>' + '\\n'}}{% endfor %}"
          "{% if add_generation_prompt %}{{ '<|im_start|>assistant\\n' }}"
          "{% endif %}")

LLAMA3 = """{{- bos_token }}
{%- if messages[0]['role'] == 'system' %}
    {%- set system_message = messages[0]['content']|trim %}
    {%- set messages = messages[1:] %}
{%- else %}
    {%- set system_message = "" %}
{%- endif %}
{{- "<|start_header_id|>system<|end_header_id|>\\n\\n" }}
{{- "Cutting Knowledge Date: December 2023\\n\\n" }}
{{- system_message }}
{{- "<|eot_id|>" }}
{%- for message in messages %}
    {{- '<|start_header_id|>' + message['role'] + '<|end_header_id|>\\n\\n'+ message['content'] | trim + '<|eot_id|>' }}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- '<|start_header_id|>assistant<|end_header_id|>\\n\\n' }}
{%- endif %}
"""

MISTRAL = """{%- if messages[0]['role'] == 'system' %}
    {%- set system_message = messages[0]['content'] %}
    {%- set loop_messages = messages[1:] %}
{%- else %}
    {%- set loop_messages = messages %}
{%- endif %}

{{- bos_token }}
{%- for message in loop_messages %}
    {%- if (message['role'] == 'user') != (loop.index0 % 2 == 0) %}
        {{- raise_exception('After the optional system message, conversation roles must alternate user/assistant/user/assistant/...') }}
    {%- endif %}
    {%- if message['role'] == 'user' %}
        {%- if loop.last and system_message is defined %}
            {{- '[INST] ' + system_message + '\\n\\n' + message['content'] + '[/INST]' }}
        {%- else %}
            {{- '[INST] ' + message['content'] + '[/INST]' }}
        {%- endif %}
    {%- elif message['role'] == 'assistant' %}
        {{- ' ' + message['content']|trim + eos_token|default('</s>') }}
    {%- else %}
        {{- raise_exception('Only user and assistant roles are supported, with the exception of an initial optional system message!') }}
    {%- endif %}
{%- endfor %}
"""

QWEN3 = """{%- if messages[0].role == 'system' %}
    {{- '<|im_start|>system\\n' + messages[0].content + '<|im_end|>\\n' }}
{%- endif %}
{%- set ns = namespace(multi_step_tool=true, last_query_index=messages|length - 1) %}
{%- for message in messages[::-1] %}
    {%- set index = (messages|length - 1) - loop.index0 %}
    {%- if ns.multi_step_tool and message.role == "user" and message.content is string and not(message.content.startswith('<tool_response>') and message.content.endswith('</tool_response>')) %}
        {%- set ns.multi_step_tool = false %}
        {%- set ns.last_query_index = index %}
    {%- endif %}
{%- endfor %}
{%- for message in messages %}
    {%- if message.content is string %}
        {%- set content = message.content %}
    {%- else %}
        {%- set content = '' %}
    {%- endif %}
    {%- if (message.role == "user") or (message.role == "system" and not loop.first) %}
        {{- '<|im_start|>' + message.role + '\\n' + content + '<|im_end|>' + '\\n' }}
    {%- elif message.role == "assistant" %}
        {%- set reasoning_content = '' %}
        {%- if message.reasoning_content is string %}
            {%- set reasoning_content = message.reasoning_content %}
        {%- else %}
            {%- if '</think>' in content %}
                {%- set reasoning_content = content.split('</think>')[0].rstrip('\\n').split('<think>')[-1].lstrip('\\n') %}
                {%- set content = content.split('</think>')[-1].lstrip('\\n') %}
            {%- endif %}
        {%- endif %}
        {%- if loop.index0 > ns.last_query_index %}
            {%- if loop.last or (not loop.last and reasoning_content) %}
                {{- '<|im_start|>' + message.role + '\\n<think>\\n' + reasoning_content.strip('\\n') + '\\n</think>\\n\\n' + content.lstrip('\\n') }}
            {%- else %}
                {{- '<|im_start|>' + message.role + '\\n' + content }}
            {%- endif %}
        {%- else %}
            {{- '<|im_start|>' + message.role + '\\n' + content }}
        {%- endif %}
        {{- '<|im_end|>\\n' }}
    {%- elif message.role == "tool" %}
        {%- if loop.first or (messages[loop.index0 - 1].role != "tool") %}
            {{- '<|im_start|>user' }}
        {%- endif %}
        {{- '\\n<tool_response>\\n' }}
        {{- content }}
        {{- '\\n</tool_response>' }}
        {%- if loop.last or (messages[loop.index0 + 1].role != "tool") %}
            {{- '<|im_end|>\\n' }}
        {%- endif %}
    {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- '<|im_start|>assistant\\n' }}
    {%- if enable_thinking is defined and enable_thinking is false %}
        {{- '<think>\\n\\n</think>\\n\\n' }}
    {%- endif %}
{%- endif %}
"""

# The rest of the grammar: comments, loop unpacking, every loop attribute,
# filters, tests, literals, arithmetic, slices, string and dict methods,
# whitespace control.
GRAMMAR = """{#- every construct the renderer implements -#}
{% set ns = namespace(chars=0, roles=[]) -%}
{% for m in messages -%}
  [{{ loop.index }}/{{ loop.length }}|{{ loop.index0 }}|{{ loop.first }}|{{ loop.last }}]
  {%- set ns.chars = ns.chars + (m.content|string|length) %}
  {{ m.role|upper }} {{ m['role']|lower ~ '!' }} {{ m.content|tojson }}
  {{- m.get('name', 'anon') }} {{ m.keys()|length }} {{ m.values()|first|default('none') }}
  {%- if m.content is string and m.content.strip() %} first={{ m.content|first }} last={{ m.content|last }} {{ m.content.split()|join('+') }} {{ m.content|replace('a', 'A') }} {{ m.content[1:4] }} {{ m.content.startswith('a') }} {{ m.content.endswith(' ') }} {{ m.content.lstrip().rstrip()|trim }}{% elif m.content is none %} none{% elif m.content is number %} num={{ m.content * 2 }} {{ m.content // 3 }} {{ m.content % 4 }} {{ m.content ** 2 }} {{ -m.content }} {{ m.content / 2 }} {{ +m.content - 1 }}{% else %} other{% endif %}
{% endfor -%}
{% for k, v in {'b': 2, 'a': [1, 2.5, 'x', none, true]}|items %}{{ k }}={{ v|tojson }};{% endfor %}
{% for k, v in {'z': 1}.items() %}{{ k }}{{ v }}{% endfor %}
{{ [1, 2, 3][-1] }} {{ (1, 2) }} {{ 'x' in 'xyz' }} {{ 4 not in [1, 2] }} {{ '42'|int + 1 }} {{ 'z'|int }} {{ 'A b'.lower() }}{{ 'a'.upper() }}{{ 'aXa'.replace('X', '-') }}
{{ 1 < 2 and 2 >= 2 or false }} {{ not true }} {{ 1 if messages else 0 }} {{ 'adult' if ns.chars > 10 }} {{ 1 != 2 }} {{ 2 <= 1 }} {{ 3 > 2 }}
{{ messages|length is number }} {{ messages is sequence }} {{ messages[0] is mapping }} {{ none is none }} {{ messages is iterable }} {{ tools is undefined }} {{ true is true }} {{ false is not false }} {{ ns is defined }} {{ 'a' is string }}
{{- "  trimmed  "|trim -}}
{{ ns.chars }} {{ ns.missing|default('d') }} {{ undefined_name|length }} {{ 'a' ~ undefined_name ~ 'b' }}
"""

# Llama 3.1's published form: tools from the messages' tool calls, a
# builtin-tools line built with reject / join, tojson(indent=4), a date
# default, and raise_exception on more than one tool call.
LLAMA31 = """{{- bos_token }}
{%- if custom_tools is defined %}
    {%- set tools = custom_tools %}
{%- endif %}
{%- if not tools_in_user_message is defined %}
    {%- set tools_in_user_message = true %}
{%- endif %}
{%- if not date_string is defined %}
    {%- set date_string = "26 Jul 2024" %}
{%- endif %}
{%- if not tools is defined %}
    {%- set tools = none %}
{%- endif %}
{%- set builtin_tools = ["brave_search", "code_interpreter", "wolfram_alpha"] %}
{%- if messages[0]['role'] == 'system' %}
    {%- set system_message = messages[0]['content']|string|trim %}
    {%- set messages = messages[1:] %}
{%- else %}
    {%- set system_message = "" %}
{%- endif %}
{{- "<|start_header_id|>system<|end_header_id|>\\n\\n" }}
{%- if builtin_tools is defined or tools is not none %}
    {{- "Environment: ipython\\n" }}
{%- endif %}
{%- if builtin_tools is defined %}
    {{- "Tools: " + builtin_tools | reject('equalto', 'code_interpreter') | join(", ") + "\\n\\n"}}
{%- endif %}
{{- "Cutting Knowledge Date: December 2023\\n" }}
{{- "Today Date: " + date_string + "\\n\\n" }}
{%- if tools is not none and not tools_in_user_message %}
    {{- "You have access to the following functions." }}
    {%- for t in tools %}
        {{- t | tojson(indent=4) }}
        {{- "\\n\\n" }}
    {%- endfor %}
{%- endif %}
{{- system_message }}
{{- "<|eot_id|>" }}
{%- for message in messages %}
    {%- if not (message.role == 'ipython' or message.role == 'tool' or 'tool_calls' in message) %}
        {{- '<|start_header_id|>' + message['role'] + '<|end_header_id|>\\n\\n'+ message['content'] | string | trim + '<|eot_id|>' }}
    {%- elif 'tool_calls' in message %}
        {%- if not message.tool_calls|length == 1 %}
            {{- raise_exception("This model only supports single tool-calls at once!") }}
        {%- endif %}
        {%- set tool_call = message.tool_calls[0].function %}
        {%- if builtin_tools is defined and tool_call.name in builtin_tools %}
            {{- '<|start_header_id|>assistant<|end_header_id|>\\n\\n' -}}
            {{- "<|python_tag|>" + tool_call.name + ".call(" }}
            {%- for arg_name, arg_val in tool_call.arguments | items %}
                {{- arg_name + '="' + arg_val|string + '"' }}
                {%- if not loop.last %}
                    {{- ", " }}
                {%- endif %}
            {%- endfor %}
            {{- ")" }}
        {%- else  %}
            {{- '<|start_header_id|>assistant<|end_header_id|>\\n\\n' -}}
            {{- '{"name": "' + tool_call.name + '", ' }}
            {{- '"parameters": ' }}
            {{- tool_call.arguments | tojson }}
            {{- "}" }}
        {%- endif %}
        {{- "<|eom_id|>" }}
    {%- elif message.role == "tool" or message.role == "ipython" %}
        {{- "<|start_header_id|>ipython<|end_header_id|>\\n\\n" }}
        {%- if message.content is mapping or message.content is iterable %}
            {{- message.content | tojson }}
        {%- else %}
            {{- message.content }}
        {%- endif %}
        {{- "<|eot_id|>" }}
    {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- '<|start_header_id|>assistant<|end_header_id|>\\n\\n' }}
{%- endif %}
"""

# Qwen3's tool-call half: macros, tool_calls with a function swap inside the
# loop, tojson of arguments that are strings or mappings, and the
# consecutive-tool grouping by loop index.
QWEN3_TOOLS = """{%- macro render_content(content) -%}
    {%- if content is string -%}{{- content -}}
    {%- elif content is iterable and content is not mapping -%}
        {%- for part in content if part.type == 'text' -%}{{- part.text -}}{%- endfor -%}
    {%- else -%}{{- content | string -}}
    {%- endif -%}
{%- endmacro -%}
{%- set tools = [{"type": "function", "function": {"name": "get_weather", "parameters": {"type": "object", "properties": {"city": {"type": "string"}}}}}] %}
{{- '<|im_start|>system\\n# Tools\\n<tools>' }}
{%- for tool in tools %}
    {{- "\\n" }}
    {{- tool | tojson }}
{%- endfor %}
{{- "\\n</tools><|im_end|>\\n" }}
{%- for message in messages %}
    {%- set content = render_content(message.content) %}
    {%- if message.role == "assistant" %}
        {{- '<|im_start|>' + message.role + '\\n' + content }}
        {%- if message.tool_calls %}
            {%- for tool_call in message.tool_calls %}
                {%- if (loop.first and content) or (not loop.first) %}
                    {{- '\\n' }}
                {%- endif %}
                {%- if tool_call.function %}
                    {%- set tool_call = tool_call.function %}
                {%- endif %}
                {{- '<tool_call>\\n{"name": "' }}
                {{- tool_call.name }}
                {{- '", "arguments": ' }}
                {%- if tool_call.arguments is string %}
                    {{- tool_call.arguments }}
                {%- else %}
                    {{- tool_call.arguments | tojson }}
                {%- endif %}
                {{- '}\\n</tool_call>' }}
            {%- endfor %}
        {%- endif %}
        {{- '<|im_end|>\\n' }}
    {%- elif message.role == "tool" %}
        {%- if loop.first or (messages[loop.index0 - 1].role != "tool") %}
            {{- '<|im_start|>user' }}
        {%- endif %}
        {{- '\\n<tool_response>\\n' ~ content ~ '\\n</tool_response>' }}
        {%- if loop.last or (messages[loop.index0 + 1].role != "tool") %}
            {{- '<|im_end|>\\n' }}
        {%- endif %}
    {%- else %}
        {{- '<|im_start|>' ~ message.role ~ '\\n' ~ content ~ '<|im_end|>\\n' }}
    {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}{{- '<|im_start|>assistant\\n' }}{%- endif %}
"""

# gpt-oss's (harmony) published form: recursive macros with defaults that
# render a tool schema as TypeScript, a macro called for its string, a
# {% set %} block, selectattr / map over the messages, loop.last, and the
# developer / analysis / final channel split.
GPTOSS = """{#- harmony-style chat template -#}
{%- macro render_typescript_type(param_spec, required_params, is_nullable=false) -%}
    {%- if param_spec.type == "array" -%}
        {%- if param_spec['items'] -%}
            {{- render_typescript_type(param_spec['items'], required_params) + "[]" -}}
        {%- else -%}{{- "any[]" -}}{%- endif -%}
        {%- if is_nullable -%}{{- " | null" -}}{%- endif -%}
    {%- elif param_spec.type == "string" -%}
        {%- if param_spec.enum -%}
            {{- '"' + param_spec.enum|join('" | "') + '"' -}}
        {%- else -%}{{- "string" -}}{%- endif -%}
    {%- elif param_spec.type in ["number", "integer"] -%}{{- "number" -}}
    {%- elif param_spec.type == "object" -%}
        {%- if param_spec.properties -%}
            {{- "{\\n" -}}
            {%- for prop_name, prop_spec in param_spec.properties|dictsort -%}
                {{- prop_name -}}
                {%- if prop_name not in (param_spec.required or []) -%}{{- "?" -}}{%- endif -%}
                {{- ": " -}}
                {{- render_typescript_type(prop_spec, param_spec.required or []) -}}
                {%- if not loop.last -%}{{- ",\\n" -}}{%- endif -%}
            {%- endfor -%}
            {{- "\\n}" -}}
        {%- else -%}{{- "object" -}}{%- endif -%}
    {%- else -%}{{- "any" -}}
    {%- endif -%}
{%- endmacro -%}
{%- macro render_tool_namespace(namespace_name, tools) -%}
    {{- "## " + namespace_name + "\\n\\n" -}}
    {{- "namespace " + namespace_name + " {\\n\\n" -}}
    {%- for tool in tools -%}
        {%- set tool = tool.function -%}
        {{- "// " + tool.description + "\\n" -}}
        {{- "type "+ tool.name + " = " -}}
        {%- if tool.parameters and tool.parameters.properties -%}
            {{- "(_: " + render_typescript_type(tool.parameters, tool.parameters.required or []) + ") => any;\\n\\n" -}}
        {%- else -%}{{- "() => any;\\n\\n" -}}{%- endif -%}
    {%- endfor -%}
    {{- "} // namespace " + namespace_name -}}
{%- endmacro -%}
{%- macro build_system_message(reasoning_effort="medium") -%}
    {{- "You are ChatGPT, a large language model trained by OpenAI.\\n" -}}
    {{- "Reasoning: " + reasoning_effort + "\\n\\n" -}}
    {{- "# Valid channels: analysis, commentary, final." -}}
{%- endmacro -%}
{%- set tools = [{"function": {"name": "lookup", "description": "Find a word", "parameters": {"type": "object", "required": ["word"], "properties": {"word": {"type": "string"}, "limit": {"type": "integer"}, "kinds": {"type": "array", "items": {"type": "string", "enum": ["noun", "verb"]}}}}}}] -%}
{{- "<|start|>system<|message|>" -}}
{{- build_system_message() -}}
{{- "<|end|>" -}}
{%- set developer = messages|selectattr("role", "equalto", "developer")|map(attribute="content")|list -%}
{%- set system_texts = messages|selectattr("role", "in", ["system"])|map(attribute="content")|map("string")|list -%}
{%- set header -%}
    {{- "<|start|>developer<|message|>" -}}
    {%- if system_texts or developer -%}
        {{- "# Instructions\\n\\n" + (system_texts + developer)|join("\\n") + "\\n\\n" -}}
    {%- endif -%}
    {{- "# Tools\\n\\n" + render_tool_namespace("functions", tools) -}}
    {{- "<|end|>" -}}
{%- endset -%}
{{- header -}}
{%- for message in messages|rejectattr("role", "in", ["system", "developer"]) -%}
    {%- if message.role == "assistant" -%}
        {%- if message.thinking is defined and message.thinking -%}
            {{- "<|start|>assistant<|channel|>analysis<|message|>" + message.thinking + "<|end|>" -}}
        {%- endif -%}
        {{- "<|start|>assistant<|channel|>final<|message|>" + message.content|string + ("<|return|>" if loop.last else "<|end|>") -}}
    {%- elif message.role == "tool" -%}
        {{- "<|start|>functions.lookup to=assistant<|channel|>commentary<|message|>" + message.content|tojson + "<|end|>" -}}
    {%- else -%}
        {{- "<|start|>" + message.role + "<|message|>" + message.content|string + "<|end|>" -}}
    {%- endif -%}
{%- endfor -%}
{%- if add_generation_prompt -%}<|start|>assistant{%- endif -%}
"""

RAISE = ("{% for m in messages %}{% if m.role not in ['user', 'assistant', "
         "'system'] %}{{ raise_exception('unknown role ' + m.role) }}"
         "{% endif %}{{ m.role }}: {{ m.content }}\n{% endfor %}")

TEMPLATES = {"default": REF_DEFAULT, "chatml": CHATML, "llama3": LLAMA3,
             "llama31": LLAMA31, "mistral": MISTRAL, "qwen3": QWEN3,
             "qwen3-tools": QWEN3_TOOLS, "gptoss": GPTOSS,
             "grammar": GRAMMAR, "raise": RAISE}

_TEXT = st.one_of(
    st.text(max_size=20),
    st.sampled_from(["", " ", "\n", "hello world", "<think>r</think>\nans",
                     "<tool_response>x</tool_response>", "{{ x }}",
                     "{% if %}", "a\r\nb", "  padded  ", "ünï 😀 𝐀"]))
_CONTENT = st.one_of(_TEXT, _TEXT, st.none(), st.integers(-5, 50),
                     st.lists(st.fixed_dictionaries(
                         {"type": st.sampled_from(["text", "image_url"]),
                          "text": _TEXT}), max_size=2))
_MESSAGE = st.fixed_dictionaries(
    {"role": st.sampled_from(["system", "user", "assistant", "tool",
                              "developer"])},
    optional={"content": _CONTENT, "name": _TEXT,
              "reasoning_content": _TEXT})
_MESSAGES = st.lists(_MESSAGE, min_size=1, max_size=5)


def _outcome(render, messages):
    try:
        return "ok", render(copy.deepcopy(messages))
    except (RequestError, RefRequestError) as exc:
        return "request_error", str(exc)
    except TemplateError:
        return "template_error", None
    except Exception:  # noqa: BLE001 — jinja2's errors while rendering
        return "template_error", None


@pytest.fixture(scope="module")
def preprocessors():
    out = {}
    for name, source in TEMPLATES.items():
        ref = RefPreprocessor(RefCard(name="m", chat_template=source))
        port = OpenAIPreprocessor(ModelDeploymentCard(name="m",
                                                      chat_template=source))
        assert port.template is not None  # inside the grammar
        out[name] = (ref, port)
    return out


@settings(max_examples=60, deadline=None)
@given(messages=_MESSAGES)
@pytest.mark.parametrize("name", sorted(TEMPLATES))
def test_renders_as_jinja2(preprocessors, name, messages):
    ref, port = preprocessors[name]
    want = _outcome(ref.render_chat, messages)
    got = _outcome(port.render_chat, messages)
    assert got == want


def test_the_templates_render_and_fail_where_they_should(preprocessors):
    """The fixed cases the hypothesis runs must not leave to chance."""
    user = [{"role": "user", "content": "hi"}]
    chat = [{"role": "system", "content": " sys "}, *user,
            {"role": "assistant", "content": "<think>why</think>\nyes"},
            {"role": "user", "content": "again"}]
    for name in TEMPLATES:
        ref, port = preprocessors[name]
        for messages in (user, chat):
            want = _outcome(ref.render_chat, messages)
            assert _outcome(port.render_chat, messages) == want
            if name != "mistral":
                assert want[0] == "ok", (name, want)
    ref, port = preprocessors["raise"]
    bad = [{"role": "tool", "content": "x"}]
    assert _outcome(ref.render_chat, bad) == ("template_error", None)
    with pytest.raises(TemplateError, match="raise_exception"):
        port.render_chat(copy.deepcopy(bad))
    # mistral: roles that do not alternate reach raise_exception
    ref, port = preprocessors["mistral"]
    two = [{"role": "user", "content": "a"}, {"role": "user", "content": "b"}]
    assert _outcome(port.render_chat, two) == ("template_error", None)
    assert _outcome(ref.render_chat, two) == ("template_error", None)


# What stays refused at parse time: jinja2's own syntax errors (an unknown
# filter or test outside an `if` included), the extensions' tags, the tags
# that need a loader or inheritance (jinja2 parses them and fails at render
# without a loader), attributes starting with "_" (which a plain jinja2
# environment reads) and `{% autoescape %}` (which jinja2 renders; the
# last three are logged differences, ROADMAP Queue 3).
@pytest.mark.parametrize("source", [
    "{% if x %}unclosed",
    "{{ }}",
    "{% endfor %}",
    "{{ 1 + }}",
    "{% set 1 = 2 %}",
    "{% macro m(a=1, b) %}{% endmacro %}",
    "{% for loop in messages %}{% endfor %}",
    "{{ x|no_such_filter }}",
    "{{ x is no_such_test }}",
    "{% for m in messages %}{{ m }}{% elif x %}{% endfor %}",
    "{% call x %}{% endcall %}",
    "{{ x is defined is defined }}",
    "{% generation %}x{% endgeneration %}",
    "{% for m in messages %}{% break %}{% endfor %}",
    "{% do messages.append(1) %}",
    "{% include 'chat.jinja' %}",
    "{% import 'macros.jinja' as m %}",
    "{% from 'macros.jinja' import m %}",
    "{% extends 'base.jinja' %}",
    "{% block content %}x{% endblock %}",
    "{{ messages.__class__ }}",
    "{{ messages[0]._private }}",
    "{% set ns = namespace() %}{% set ns._x = 1 %}",
    "{% autoescape true %}{{ x }}{% endautoescape %}",
])
def test_outside_the_grammar_is_refused(source):
    with pytest.raises(TemplateSyntaxError):
        ChatTemplate(source)
    pre = OpenAIPreprocessor(ModelDeploymentCard(name="m",
                                                 chat_template=source))
    assert pre.template is None and pre.template_refused
    with pytest.raises(RequestError, match="outside the renderer's grammar"):
        pre.preprocess_chat({"messages": [{"role": "user",
                                           "content": "x"}]})
    # completions do not render the template
    assert pre.preprocess_completions({"prompt": "x"}).token_ids == [120]


def test_tool_messages_render_as_jinja2(preprocessors):
    """The tool-using templates over a conversation with tool calls, a
    developer message, an assistant's thinking and a mapping tool
    result."""
    chat = [{"role": "system", "content": "sys"},
            {"role": "developer", "content": "dev"},
            {"role": "user", "content": "hi"},
            {"role": "assistant", "content": "yo", "thinking": "hmm",
             "tool_calls": [{"function": {"name": "get_weather",
                                          "arguments": {"city": "x"}}}]},
            {"role": "tool", "content": {"r": 1}},
            {"role": "user", "content": "again"}]
    for name in ("llama31", "qwen3-tools", "gptoss"):
        ref, port = preprocessors[name]
        want = _outcome(ref.render_chat, chat)
        assert want[0] == "ok" and _outcome(port.render_chat, chat) == want
    ref, port = preprocessors["llama31"]
    two = copy.deepcopy(chat)
    two[3]["tool_calls"] *= 2
    assert _outcome(ref.render_chat, two) == _outcome(
        port.render_chat, two) == ("template_error", None)


# Every construct of the grammar on its own, rendered with CONTEXT.
CONSTRUCTS = {
    # macros: defaults (one reading an earlier argument), varargs, kwargs,
    # caller() with and without arguments, a call block, recursion,
    # whitespace control around bodies, late binding, argument errors
    "macro-defaults": "{% macro m(a, b=a * 2, c='z') %}[{{ a }}|{{ b }}|{{ c }}]{% endmacro %}{{ m(1) }}{{ m(1, c=3) }}{{ m(b=5, a=2) }}",
    "macro-missing-argument": "{% macro m(a, b) %}[{{ a }}|{{ b is defined }}]{% endmacro %}{{ m() }}{{ m(b=1) }}",
    "macro-varargs-kwargs": "{% macro m(a) %}{{ a }}{{ varargs }}{{ kwargs|dictsort }}{% endmacro %}{{ m(1, 2, 3, k=4, j=5) }}",
    "macro-too-many": "{% macro m(a) %}{{ a }}{% endmacro %}{{ m(1, 2) }}",
    "macro-unknown-kwarg": "{% macro m(a) %}{{ a }}{% endmacro %}{{ m(1, k=2) }}",
    "macro-attributes": "{% macro m(a, b) %}{% endmacro %}{{ m.name }}{{ m.arguments }}{{ m.catch_kwargs }}{{ m.caller }}",
    "macro-caller": "{% macro box(title) -%}\n  <{{ title }}>\n  {{- caller() -}}\n  </{{ title }}>\n{%- endmacro %}\n{% call box('b') -%}\n  inner {{ x }}\n{%- endcall %}",
    "macro-caller-args": "{% macro each(xs) %}{% for v in xs %}{{ caller(v, loop.index) }}{% endfor %}{% endmacro %}{% call(v, i) each([3, 4]) %}{{ i }}={{ v }};{% endcall %}",
    "macro-no-caller": "{% macro m() %}{{ caller() }}{% endmacro %}{{ m() }}",
    "macro-caller-not-taken": "{% macro m() %}x{% endmacro %}{% call m() %}b{% endcall %}",
    "macro-recursive": "{% macro tree(n) %}{{ n.name }}{% if n.kids %}({% for k in n.kids %}{{ tree(k) }}{% if not loop.last %},{% endif %}{% endfor %}){% endif %}{% endmacro %}{{ tree({'name': 'a', 'kids': [{'name': 'b', 'kids': [{'name': 'c'}]}, {'name': 'd'}]}) }}",
    "macro-late-binding": "{% set v = 1 %}{% macro m() %}{{ v }}{% endmacro %}{% set v = 2 %}{{ m() }}",
    "macro-sees-globals-not-loop": "{% macro m() %}{{ i }}|{{ x }}{% endmacro %}{% for i in [1] %}{{ m() }}{% endfor %}",
    "macro-in-loop-sees-loop": "{% for i in [1, 2] %}{% macro m() %}{{ i }}{% endmacro %}{{ m() }}{% endfor %}",
    "macro-returns-string": "{% macro m() %}<{{ 1 }}>{% endmacro %}{{ m() is string }}{{ m() ~ '&' }}{{ m()|length }}",
    # set blocks, filter blocks, with
    "set-block": "{% set v %}a{{ 1 + 1 }}\n b{% endset %}[{{ v }}]{{ v is string }}",
    "set-block-filter": "{% set v | upper | replace('A', '4') %}abc {{ x }}{% endset %}{{ v }}",
    "set-tuple": "{% set a, b = 1, 2 %}{% set (c, d) = [3, 4] %}{{ a }}{{ b }}{{ c }}{{ d }}",
    "filter-block": "{% filter upper %}ab{{ 'c' }}{% endfilter %}{% filter indent(2, true)|trim %} x\ny{% endfilter %}",
    "with": "{% set a = 5 %}{% with a = 1, b = a %}{{ a }}{{ b }}{% set c = 3 %}{% endwith %}{{ a }}{{ c }}",
    # for: loop filters, else, recursion, every loop attribute
    "for-if": "{% for m in messages if m.role != 'system' %}{{ loop.index }}/{{ loop.length }}:{{ m.role }} {% endfor %}",
    "for-else": "{% for m in [] %}{{ m }}{% else %}empty{% endfor %}{% for m in messages if false %}{% else %}none{% endfor %}{% for m in [1] %}{{ m }}{% else %}never{% endfor %}",
    "for-recursive": "{% for n in [{'v': 1, 'c': [{'v': 2, 'c': [{'v': 3}]}]}, {'v': 4}] recursive %}{{ loop.depth }}{{ loop.depth0 }}:{{ n.v }}{% if n.c %}[{{ loop(n.c) }}]{% endif %}{% endfor %}",
    "for-not-recursive": "{% for n in [1] %}{{ loop([2]) }}{% endfor %}",
    "loop-attributes": "{% for v in 'abc' %}{{ loop.index }}{{ loop.index0 }}{{ loop.revindex }}{{ loop.revindex0 }}{{ loop.first }}{{ loop.last }}{{ loop.length }}{{ loop.previtem }}{{ loop.nextitem }};{% endfor %}",
    "loop-cycle-changed": "{% for m in messages %}{{ loop.cycle('odd', 'even') }}{{ loop.changed(m.role == 'user') }} {% endfor %}",
    "loop-repr-and-nesting": "{% for a in [1, 2] %}{{ loop }}{% set outer = loop %}{% for b in [3] %}{{ loop.index }}{{ outer.index }}{{ loop.depth }}{% endfor %}{% endfor %}",
    "for-unpack-items": "{% for k, v in {'b': 1, 'a': 2}.items() %}{{ k }}{{ v }}{% endfor %}{% for a, b in [[1, 2], 'xy'] %}{{ a }}{{ b }}{% endfor %}",
    # globals
    "range": "{{ range(3)|list }}{{ range(1, 10, 3)|list }}{{ range(3) }}{% for i in range(2) %}{{ i }}{% endfor %}",
    "dict": "{{ dict(a=1, b=[2])|dictsort }}{{ dict(a=1)['a'] }}",
    "cycler": "{% set c = cycler('a', 'b') %}{{ c.next() }}{{ c.next() }}{{ c.current }}{{ c.next() }}{{ c.reset() }}{{ c.current }}",
    "joiner": "{% set j = joiner(' | ') %}{% for m in messages %}{{ j() }}{{ m.role }}{% endfor %}",
    "namespace": "{% set ns = namespace(n=0, seen=[]) %}{% for m in messages %}{% set ns.n = ns.n + 1 %}{% set local = 1 %}{% endfor %}{{ ns.n }}{{ local }}{{ ns }}",
    "set-in-loop-does-not-leak": "{% set v = 'out' %}{% for m in [1, 2] %}{{ v }}{% set v = m %}{{ v }}{% endfor %}{{ v }}{% if true %}{% set v = 'if' %}{% endif %}{{ v }}",
    # filters
    "select-reject": "{{ [1, 2, 3, 4]|select('odd')|list }}{{ [1, 2, 3]|reject('odd')|list }}{{ [0, 1, '', 'a']|select|list }}{{ [0, 1]|reject|list }}{{ [1, 5, 9]|select('gt', 4)|list }}{{ ['a', 'b']|reject('in', ['a'])|list }}",
    "selectattr-rejectattr": "{{ messages|selectattr('role', 'equalto', 'user')|map(attribute='content')|list }}{{ messages|rejectattr('tool_calls')|map(attribute='role')|join(',') }}{{ messages|selectattr('tool_calls', 'defined')|list|length }}",
    "map": "{{ messages|map(attribute='role')|map('upper')|list }}{{ messages|map(attribute='name', default='anon')|list }}{{ [1.5, 2.5]|map('round')|list }}{{ ['a,b']|map('replace', ',', ';')|list }}",
    "list-unique-sort-reverse": "{{ 'cab'|list }}{{ [3, 1, 3, 'B'|lower, 'b']|map('string')|unique|list }}{{ ['B', 'a', 'C']|sort }}{{ ['B', 'a']|sort(case_sensitive=true) }}{{ [3, 1, 2]|sort(reverse=true) }}{{ messages|sort(attribute='role,content')|map(attribute='role')|list }}{{ [1, 2]|reverse|list }}{{ 'abc'|reverse }}",
    "dictsort": "{{ {'b': 1, 'A': 2, 'c': 0}|dictsort }}{{ {'b': 1, 'A': 2}|dictsort(true) }}{{ {'b': 1, 'a': 2}|dictsort(by='value', reverse=true) }}",
    "strings": "{{ 'hELLo wORLD'|capitalize }}|{{ 'hello-world (x) <y'|title }}|{{ 'ab'|center(6) }}|{{ 'a\nb\n\nc'|indent }}|{{ 'a\nb'|indent('> ', first=true) }}|{{ 'a\n\nb'|indent(2, blank=true) }}|{{ '  s  '|trim }}|{{ 'xxsxx'|trim('x') }}",
    "numbers": "{{ '3.5'|float }}{{ 'x'|float }}{{ 'x'|float(1.5) }}{{ -2|abs }}{{ 2.567|round(2) }}{{ 2.5|round }}{{ 2.1|round(0, 'ceil') }}{{ 2.9|round(1, 'floor') }}{{ '42'|int }}{{ '0x1A'|int(0, 16) }}{{ '4.7'|int }}{{ 'z'|int(9) }}",
    "min-max-sum": "{{ [3, 1, 2]|min }}{{ [3, 1, 2]|max }}{{ ['b', 'A']|min }}{{ ['b', 'A']|max(case_sensitive=true) }}{{ []|max }}{{ [{'n': 2}, {'n': 5}]|max(attribute='n') }}{{ [1, 2]|sum }}{{ [{'n': 2}, {'n': 5}]|sum(attribute='n', start=10) }}",
    "batch-slice": "{{ [1, 2, 3, 4, 5]|batch(2)|list }}{{ [1, 2, 3]|batch(2, 'x')|list }}{{ [1, 2, 3, 4, 5]|slice(3)|list }}{{ [1, 2, 3, 4]|slice(3, 0)|list }}",
    "format": "{{ '%s-%05.1f'|format('a', 2.25) }}{{ '%(a)s'|format(a=1) }}{{ '{}:{b}'.format(1, b='x') }}{{ '{0!r}'.format('q') }}",
    "truncate-wordcount-wordwrap": "{{ 'hello world foo bar baz'|truncate(12) }}|{{ 'hello world foo bar baz'|truncate(12, true) }}|{{ 'hello world foo'|truncate(13) }}|{{ 'short'|truncate(3, end='') }}|{{ 'a b-c d'|wordcount }}|{{ 'aaa bbb ccc ddd eee'|wordwrap(7) }}",
    "escape-safe-urlencode-pprint": "{{ x|escape }}|{{ x|e|e }}|{{ x|safe }}|{{ x|forceescape }}|{{ 'a b&c/d'|urlencode }}|{{ {'k': 'v w', 'z': 1}|urlencode }}|{{ [('a', 'b')]|urlencode }}|{{ {'b': [1, {'c': 2}], 'a': 'x'}|pprint }}",
    "more-filters": "{{ x|length }}{{ messages|count }}{{ [1, 2]|first }}{{ []|first }}{{ 'ab'|last }}{{ {'a': 1}|items|list }}{{ none|default('d') }}{{ undefined_name|d('u') }}{{ ''|default('e', true) }}{{ 'a'|attr('upper')() }}{{ 'x'|string }}{{ '<p>a <b>b</b></p>'|striptags }}{{ 1234567|filesizeformat }}{{ 1024|filesizeformat(true) }}{{ {'id': 'a', 'n': none}|xmlattr }}{{ [1, 2]|join }}{{ messages|join(',', attribute='role') }}",
    "groupby": "{% for g in messages|groupby('role') %}{{ g.grouper }}:{{ g.list|length }} {% endfor %}{{ [{'k': 'A'}, {'k': 'a'}]|groupby('k') }}",
    "tojson": "{{ {'b': '<&>\\'', 'a': [1, none, true]}|tojson }}{{ [1, {'x': 2}]|tojson(indent=2) }}{{ 'é'|tojson }}",
    # tests
    "tests": "{{ 3 is odd }}{{ 3 is even }}{{ 9 is divisibleby 3 }}{{ 9 is divisibleby(4) }}{{ 'ab' is lower }}{{ 'AB' is upper }}{{ true is boolean }}{{ 1 is boolean }}{{ 1.0 is float }}{{ 1 is integer }}{{ true is integer }}{{ range is callable }}{{ 1 is callable }}{{ none is sameas none }}{{ x|e is escaped }}{{ x is escaped }}{{ 'upper' is filter }}{{ 'odd' is test }}{{ 'nope' is filter }}",
    "comparison-tests": "{{ 1 is eq 1 }}{{ 1 is ne 2 }}{{ 1 is lt 2 }}{{ 1 is le 1 }}{{ 2 is gt 1 }}{{ 2 is ge 3 }}{{ 1 is in [1] }}{{ 1 is equalto 1 }}{{ 2 is greaterthan 1 }}{{ 1 is lessthan 0 }}{{ [1, 2, 3]|select('==', 2)|list }}{{ [1, 2, 3]|select('<=', 2)|list }}",
    "type-tests": "{{ messages is sequence }}{{ messages[0] is mapping }}{{ 1 is number }}{{ x is string }}{{ messages is iterable }}{{ 1 is iterable }}{{ none is none }}{{ nothing is undefined }}{{ x is defined }}{{ true is true }}{{ false is false }}{{ 0 is false }}",
    # Markup
    "markup": "{{ 'a'|tojson + '<' }}|{{ '<' + 'a'|tojson }}|{{ x|e + x }}|{{ (x|e) ~ x }}|{{ x|safe + x }}|{{ ('%s'|safe) % x }}|{{ ('{}'|safe).format(x) }}|{{ ('<a>'|safe).upper() }}|{{ ('a,b'|safe).split(',') }}|{{ (','|safe).join([x, 'y']) }}|{{ x|e|length }}|{{ (x|e)[0] }}",
    "markup-string-filters": "{{ (x|e)|upper }}|{{ (x|e)|replace('&', '+') }}|{{ (x|e)|trim }}|{{ (x|e)|string }}|{{ ['<', x|e]|join }}|{{ ('<b> x'|safe)|title }}|{{ ('<b>'|safe)|center(9) }}",
    # expressions
    "expressions": "{{ 1 < 2 < 3 }}{{ 3 > 2 > 2 }}{{ 2 ** 3 ** 2 }}{{ -2 ** 2 }}{{ 7 // 2 }}{{ 7 % 3 }}{{ 7 / 2 }}{{ 'a' 'b' }}{{ (1, 2) }}{{ (1,) }}{{ () }}{{ [1, 2,] }}{{ {'a': 1,} }}{{ 1 if false }}{{ 'y' if true else 'n' }}{{ not 1 in [2] }}{{ x.0 }}{{ 'abc'[::-1] }}{{ 'abc'[1:] }}{{ 0x1F }}{{ 1_000 }}{{ 1e3 }}{{ 2.5e-1 }}",
    "calls": "{% set args = [1, 2] %}{% set kw = {'c': 3} %}{% macro m(a, b, c=0) %}{{ a }}{{ b }}{{ c }}{% endmacro %}{{ m(*args) }}{{ m(*args, **kw) }}{{ m(1, b=2, **kw) }}{{ dict(**kw) }}",
    "methods": "{{ messages[2].content.upper() }}{{ 'a-b'.split('-') }}{{ ' x '.strip() }}{{ 'abc'.startswith('a') }}{{ {'a': 1}.get('b', 2) }}{{ ', '.join(['a', 'b']) }}{{ 'x'.zfill(3) }}{{ messages|length }}{% set l = [] %}{{ l.append(1) }}{{ l }}",
    "undefined": "{{ nothing }}|{{ nothing|length }}|{{ 'a' ~ nothing }}|{% for n in nothing %}{{ n }}{% endfor %}|{{ nothing is defined }}|{{ messages[0].missing }}|{{ messages[0].missing is defined }}",
    "undefined-attribute-fails": "{{ nothing.attr }}",
    "undefined-arithmetic-fails": "{{ nothing + 1 }}",
    "undefined-call-fails": "{{ raise_exception('no') }}",
    "unknown-filter-in-if": "{% if false %}{{ x|no_such_filter }}{% endif %}ok{{ 'a' if true else x|no_such_filter }}",
    "unknown-filter-in-if-taken": "{% if true %}{{ x|no_such_filter }}{% endif %}",
    "print-raw-comments": "{% print 1, 'a' %}{% raw %}{{ not rendered }}{% endraw %}{# a {{ comment }} #}{%- raw -%}  raw  {%- endraw -%}  !",
    "whitespace": "a  {{- 1 -}}  b {%- if true -%}  c  {%- endif %}  d\n{%+ if true %}e{% endif +%}\n{#- c -#}\n f\n",
    "dict-literal-braces": "{{ {'a': {'b': 1}}}}{{ {'a': [1, {'x': 2}]}['a'][1]['x']}}",
}
CONTEXT = {"messages": [
    {"role": "system", "content": "sys"},
    {"role": "user", "content": "hi", "name": "u"},
    {"role": "user", "content": "again"},
    {"role": "assistant", "content": "yo",
     "tool_calls": [{"function": {"name": "f", "arguments": "{}"}}]},
    {"role": "tool", "content": "42"}],
    "add_generation_prompt": True, "x": "<b>&'\""}


def _render(render, source):
    """('ok', text), ('syntax',) or ('error',)."""
    try:
        template = render(source)
    except (jinja2.TemplateSyntaxError, TemplateSyntaxError):
        return ("syntax",)
    try:
        return ("ok", template.render(**copy.deepcopy(CONTEXT)))
    except Exception:  # noqa: BLE001 — jinja2's or the port's render error
        return ("error",)


@pytest.mark.parametrize("name", sorted(CONSTRUCTS))
def test_constructs_render_as_jinja2(name):
    source = CONSTRUCTS[name]
    want = _render(jinja2.Environment().from_string, source)
    got = _render(ChatTemplate, source)
    assert got == want
    failing = name.endswith(("-fails", "-too-many", "-unknown-kwarg",
                             "-no-caller", "-not-taken", "-taken",
                             "-not-recursive"))
    assert want[0] == ("error" if failing else "ok"), want
